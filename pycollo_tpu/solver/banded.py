"""Block-tridiagonal + arrowhead + low-rank KKT factorization.

On-device replacement for the sparse symmetric-indefinite factorization
the reference gets from MUMPS inside IPOPT (``pycollo/backend.py:1695-1711``;
the time-banded block pattern is visible in the reference's Hessian
sparsity assembly, ``pycollo/iteration.py:1039-1052``).

The condensed-space KKT matrix of a direct-collocation NLP has the shape

    K_full = M + G D_ib^{-1} G^T,      M = [[T, C^T],
                                            [C, B ]]

where

* ``T`` is block tridiagonal over mesh *sections* (defect constraints
  couple only nodes within a section; adjacent sections overlap in one
  shared boundary node, so the off-diagonal blocks are nonzero only in
  the shared node's ``nz`` columns),
* ``B`` is a small dense *border* (endpoint node variables, integrals
  ``q``, phase times ``t0/tF``, global parameters ``s``) with coupling
  ``C`` to the banded interior, and
* ``G D_ib^{-1} G^T`` is the low-rank contribution of condensed integral
  constraint rows (each integral row touches every mesh node through the
  quadrature weights — dense but rank ``nq``).

Factorization is three nested Schur layers, each a Cholesky with a
positive-definiteness certificate (NaN/non-positive pivots), replacing
MUMPS' inertia detection:

1. block-tridiagonal Cholesky of ``T`` via ``lax.scan`` — O(K) compile
   size, O(K * MB^3) FLOPs instead of O((K*MB)^3) dense;
2. dense Cholesky of the border Schur complement ``B - C T^-1 C^T``;
3. dense Cholesky of the Woodbury capacitance ``D_ib + G^T M^-1 G``.

All inner solves use backward-stable triangular SUBSTITUTION (explicit
precomputed block inverses were measured to lose ~6 digits at the block
condition numbers the condensed KKT reaches near a solution); the whole
factorization still vectorizes cleanly under ``vmap`` over problem
instances and over speculative regularization levels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BTDFactors(NamedTuple):
    """Cholesky factors of a block-tridiagonal SPD matrix.

    ``L[k]`` is the k-th diagonal Cholesky block (applied by
    backward-stable triangular SUBSTITUTION — precomputed explicit
    inverses were measured to lose ~6 digits at the block condition
    numbers the condensed KKT produces near a solution, making the
    factored solve irreproducible across XLA compilations);
    ``F[k]`` is the off-diagonal factor block (rows of group k, last-nz
    columns of group k-1; ``F[0]`` is zero).
    """

    L: jnp.ndarray        # (K, MB, MB)
    F: jnp.ndarray        # (K, MB, nz)
    ok: jnp.ndarray       # () bool — positive definite everywhere


def _tri_solve(L, b, trans=0):
    return jax.scipy.linalg.solve_triangular(L, b, lower=True,
                                             trans=trans)


def btd_factor(Dblk, Ublk) -> BTDFactors:
    """Factor a block-tridiagonal SPD matrix T = L L^T.

    ``Dblk``: (K, MB, MB) diagonal blocks.
    ``Ublk``: (K, MB, nz) sub-diagonal blocks; ``Ublk[k]`` couples group
    k's rows to the *last nz columns* of group k-1 (the shared mesh node).
    ``Ublk[0]`` is ignored.

    Uses the corner identity ``(L^-T)[a:, a:] = (L[a:, a:])^-T`` so the
    scan carry is only the (nz, nz) corner of the previous block's
    factor.
    """
    K, MB, _ = Dblk.shape
    nz = Ublk.shape[-1]

    def step(corner_prev, inp):
        D_k, U_k, first = inp
        # F_k = U_k corner^-T  <=>  F_k^T = corner^-1 U_k^T.
        F_k = jnp.where(first, 0.0,
                        _tri_solve(corner_prev, U_k.T).T)
        S_k = D_k - F_k @ F_k.T
        L_k = jnp.linalg.cholesky(S_k)
        corner_next = L_k[MB - nz:, MB - nz:]
        return corner_next, (L_k, F_k)

    first_flags = jnp.arange(K) == 0
    init = jnp.eye(nz, dtype=Dblk.dtype)
    _, (L, F) = jax.lax.scan(step, init, (Dblk, Ublk, first_flags))
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    # A healthy (equilibrated) pivot is O(1); non-finite or
    # non-positive diagonal entries flag an indefinite matrix.
    ok = jnp.all(jnp.isfinite(L)) & jnp.all(diag > 0.0)
    return BTDFactors(L=L, F=F, ok=ok)


def btd_half_fwd(factors: BTDFactors, rhs):
    """Apply the half-solve ``y = L^-1 rhs`` of the banded factor.

    Central to stability: downstream Schur complements are formed from
    HALF-solved panels (``W = L^-1 C^T``, bounded by ``W^T W = C T^-1
    C^T <= B`` for a PD system) — never from the full solve ``T^-1 C^T``
    whose norm grows with the condition number of ``T`` and whose
    products cancel catastrophically.
    """
    vec = rhs.ndim == 2
    if vec:
        rhs = rhs[..., None]
    L, F = factors.L, factors.F
    MB = L.shape[-1]
    nz = F.shape[-1]

    def fwd(y_prev_tail, inp):
        L_k, F_k, r_k = inp
        y_k = _tri_solve(L_k, r_k - F_k @ y_prev_tail)
        return y_k[MB - nz:, :], y_k

    init = jnp.zeros((nz, rhs.shape[-1]), rhs.dtype)
    _, y = jax.lax.scan(fwd, init, (L, F, rhs))
    return y[..., 0] if vec else y


def btd_half_bwd(factors: BTDFactors, y):
    """Apply the half-solve ``x = L^-T y`` of the banded factor."""
    vec = y.ndim == 2
    if vec:
        y = y[..., None]
    L, F = factors.L, factors.F
    MB = L.shape[-1]
    nz = F.shape[-1]

    def bwd(x_next_contrib, inp):
        # carry in: F_{k+1}^T x_{k+1} (hits the last nz rows of block k);
        # carry out: F_k^T x_k (consumed by block k-1).
        L_k, F_k, y_k = inp
        x_k = _tri_solve(L_k, y_k - jnp.zeros_like(y_k).at[
            MB - nz:, :].set(x_next_contrib), trans=1)
        return jnp.swapaxes(F_k, -1, -2) @ x_k, x_k

    init_b = jnp.zeros((nz, y.shape[-1]), y.dtype)
    _, x = jax.lax.scan(bwd, init_b, (L, F, y), reverse=True)
    return x[..., 0] if vec else x


def btd_solve(factors: BTDFactors, rhs):
    """Solve T x = rhs with ``rhs`` of shape (K, MB, ncols) (or (K, MB))."""
    return btd_half_bwd(factors, btd_half_fwd(factors, rhs))


class PhaseBand(NamedTuple):
    """Banded data of one phase: T blocks + border coupling + G columns."""

    Dblk: jnp.ndarray     # (K, MB, MB)
    Ublk: jnp.ndarray     # (K, MB, nz)
    Cblk: jnp.ndarray     # (K, nw, MB)  border rows x group cols
    Gz: jnp.ndarray       # (K, MB, nr)  low-rank z-columns


class ArrowBlocks(NamedTuple):
    """Assembled (unregularized, unequilibrated) KKT blocks."""

    phases: tuple         # tuple[PhaseBand]
    B: jnp.ndarray        # (nw, nw) border diagonal block
    Gw: jnp.ndarray       # (nw, nr) low-rank border rows
    d_ib: jnp.ndarray     # (nr,) dual regularization of the G rows
    #: per-variable free mask in banded layout (1 = real variable,
    #: 0 = structural pad / pinned variable -> identity row)
    zmask: tuple          # tuple[(K, MB)]
    wmask: jnp.ndarray    # (nw,)


class ArrowFactors(NamedTuple):
    """Factors of the bordered (augmented) arrowhead system.

    The low-rank integral-constraint columns are NOT folded in by a
    Woodbury identity: the capacitance route ``D_ib + G^T M^-1 G``
    cancels catastrophically near a solution (the computed correction
    was measured wrong by O(100) in exactly the rank-nr directions, and
    so compilation-order-sensitive that two XLA lowerings of the same
    solve disagreed at the 30% level — un-preconditionable noise).
    Instead the integral-row duals ``y`` are kept as explicit unknowns
    in an AUGMENTED border::

        [[T,  C^T,  Gz],     [dz]    [rz]
         [C,  B,    Gw],  x  [dw]  = [rw]
         [Gz^T, Gw^T, -D]]   [y]     [0]

    After eliminating the banded interior T, the bordered Schur
    complement ``S`` is QUASI-DEFINITE (w-block PD, y-block negative
    definite), so a signed 2-block Cholesky factors it stably without
    pivoting (Vanderbei) — additive ``D`` only, no ``1/d_ib`` anywhere.
    """

    btd: tuple            # tuple[BTDFactors]
    W: tuple              # tuple[(K, MB, nw+nr)] = L_T^-1 [C^T | Gz]
    L11: jnp.ndarray      # (nw, nw) Cholesky of the w-Schur after
    #                       eliminating banded interior AND dual rows
    S12: jnp.ndarray      # (nw, nr) Schur coupling block
    L22: jnp.ndarray      # (nr, nr) Cholesky of -(S_yy after banded
    #                       elimination) = I + Gram (always PD)
    dz: tuple             # tuple[(K, MB)] equilibration scales (z)
    dwq: jnp.ndarray      # (nw,) equilibration scales (border)
    dy: jnp.ndarray       # (nr,) equilibration scales (dual rows)
    ok: jnp.ndarray       # () bool


def _chol_ok(A):
    """(L, ok) of a small dense SPD block (ok certifies PD); applied by
    substitution, never by explicit inverse (see BTDFactors note)."""
    L = jnp.linalg.cholesky(A)
    diag = jnp.diagonal(L)
    ok = jnp.all(jnp.isfinite(L)) & jnp.all(diag > 0.0)
    return L, ok


def _cho_apply(L, b):
    """(L L^T)^-1 b via two triangular substitutions."""
    return _tri_solve(L, _tri_solve(L, b), trans=1)


def arrow_factor(blocks: ArrowBlocks, dw) -> ArrowFactors:
    """Factor the augmented arrowhead system with regularization dw.

    ``dw`` is added to every *real* (non-pad) primal diagonal entry,
    matching the dense path's ``K + dw*I`` (the dual rows get none).
    Jacobi equilibration is applied throughout (the diagonal spans many
    orders of magnitude near a solution; scaling bounds the
    factorization error by the scaled condition number — the stability
    role pivoting plays inside MUMPS).  The positive-definiteness
    certificate ``ok`` checks exactly the inertia condition for a
    descent direction: banded interior PD, w-Schur PD, y-Schur negative
    definite.
    """
    eps = jnp.asarray(1e-30, blocks.B.dtype)
    nr = blocks.Gw.shape[-1]
    # Equilibrate by the CONDENSED diagonal: each variable's scaling
    # must include its integral-column mass ``sum_r G_ir^2 / d_ib_r``
    # (all positive terms — no cancellation).  Scaling by the bare
    # block diagonal explodes for variables whose mass lives entirely
    # in the integral coupling (e.g. the integral state ``q`` has
    # B_qq ~ sigma_q ~ 1e-12 at small mu while its condensed diagonal
    # is (W_i q_V)^2/dc ~ 1e6) — measured: the bordered Schur reached
    # scale 1e16 and the factorization lost 10 digits even in f128.
    # With the condensed scaling every scaled G entry is bounded by 1
    # (|G_ir| dy_r dwq_i <= 1 by construction).
    dib_inv = 1.0 / jnp.maximum(blocks.d_ib, eps) if nr else None
    phases = []
    dz_scales = []
    for pb, zm in zip(blocks.phases, blocks.zmask):
        K, MB, _ = pb.Dblk.shape
        Dreg = pb.Dblk + (dw * zm)[:, :, None] * jnp.eye(MB, dtype=pb.Dblk.dtype)
        diag = jnp.diagonal(Dreg, axis1=-2, axis2=-1)
        if nr:
            diag = diag + jnp.einsum("kmr,r,kmr->km", pb.Gz, dib_inv,
                                     pb.Gz)
        d = 1.0 / jnp.sqrt(jnp.maximum(diag, eps))
        Ds = Dreg * d[:, :, None] * d[:, None, :]
        # U couples group k rows to group k-1's last-nz cols.
        d_prev_tail = jnp.concatenate(
            [jnp.ones((1,) + d.shape[1:], d.dtype), d[:-1]], axis=0)[
                :, MB - pb.Ublk.shape[-1]:]
        Us = pb.Ublk * d[:, :, None] * d_prev_tail[:, None, :]
        phases.append((Ds, Us, d))
        dz_scales.append(d)
    Breg = blocks.B + jnp.diag(dw * blocks.wmask)
    bdiag = jnp.diagonal(Breg)
    if nr:
        bdiag = bdiag + jnp.einsum("ir,r,ir->i", blocks.Gw, dib_inv,
                                   blocks.Gw)
    dwq = 1.0 / jnp.sqrt(jnp.maximum(bdiag, eps))
    Bs = Breg * dwq[:, None] * dwq[None, :]
    # Dual-row scales: |diagonal| = d_ib > 0 (additive regularization).
    dy = 1.0 / jnp.sqrt(jnp.maximum(blocks.d_ib, eps)) if nr \
        else jnp.zeros(0, blocks.B.dtype)

    btd_factors = []
    Ws = []
    S_ww = Bs
    S_wy = blocks.Gw * dwq[:, None] * (dy[None, :] if nr else 1.0)
    S_yy = -jnp.eye(nr, dtype=blocks.B.dtype)  # -d_ib scaled by dy^2
    ok = jnp.asarray(True)
    nw = Bs.shape[0]
    for (Ds, Us, d), pb in zip(phases, blocks.phases):
        fac = btd_factor(Ds, Us)
        ok = ok & fac.ok
        Cs = pb.Cblk * dwq[:, None, None].swapaxes(0, 1) * d[:, None, :]
        Gs = pb.Gz * d[:, :, None] * (dy[None, None, :] if nr else 1.0)
        # Augmented coupling rows [C; Gz^T] -> panel (K, MB, nw+nr).
        Caug_T = jnp.concatenate([jnp.swapaxes(Cs, -1, -2), Gs], axis=-1)
        # HALF-solve panel: W = L_T^-1 C_aug^T.  The Schur update is
        # W^T W (a Gram matrix, bounded by the border diagonal for a PD
        # system) — forming the FULL solve T^-1 C_aug^T first and
        # multiplying by C was measured to lose ~14 digits here: its
        # norm grows with cond(T) and the product cancels back down.
        W = btd_half_fwd(fac, Caug_T)         # (K, MB, nw+nr)
        S_update = jnp.einsum("kma,kmb->ab", W, W)
        S_ww = S_ww - S_update[:nw, :nw]
        S_wy = S_wy - S_update[:nw, nw:]
        S_yy = S_yy - S_update[nw:, nw:]
        btd_factors.append(fac)
        Ws.append(W)
    # Eliminate the DUAL rows FIRST: their scaled diagonal is exactly
    # -1 (perfect pivot), -S_yy = I + Gram is PD by construction, and
    # the w-Schur update S_ww + P P^T is ADDITIVE — no cancellation.
    # Eliminating w first instead hits near-zero leading pivots for
    # saddle variables whose mass lives in the dual coupling (e.g. the
    # integral state q: scaled S_ww diagonal ~ 1e-18 while its true
    # mass is the G column) — measured to lose 10 digits even in f128.
    if nr:
        L22, okc = _chol_ok(-S_yy)
        P12 = _tri_solve(L22, S_wy.T).T       # S_wy L22^-T : (nw, nr)
        Wsch = S_ww + P12 @ P12.T
        L11, okb = _chol_ok(Wsch)
        ok = ok & okb & okc
    else:
        L22 = jnp.zeros((0, 0), blocks.B.dtype)
        L11, okb = _chol_ok(S_ww)
        ok = ok & okb
    return ArrowFactors(btd=tuple(btd_factors), W=tuple(Ws),
                        L11=L11, S12=S_wy, L22=L22,
                        dz=tuple(dz_scales), dwq=dwq, dy=dy, ok=ok)


def arrow_solve(factors: ArrowFactors, rz_list, rw):
    """Solve the augmented system; ``rz_list`` per-phase (K, MB),
    ``rw`` (nw,).  The dual rows' rhs is structurally zero (they are
    introduced by the exact elimination ``y = D^-1 G^T dx``).

    All coupling data comes from the stored half-solved panels
    ``factors.W`` — the assembled blocks are not needed here (advisor
    round-4: the former ``blocks`` parameter was dead)."""
    nr = factors.dy.shape[0]
    nw = rw.shape[0]
    # Equilibration: K = D^-1 Ks D^-1 with scales d -> x = d * Ks^-1 (d*r).
    rz_s = [rz * d for rz, d in zip(rz_list, factors.dz)]
    rw_s = rw * factors.dwq

    # Block-Cholesky forward pass: y1 = L_T^-1 rz (HALF solve), border
    # residual via the half panels W (all intermediates bounded — see
    # arrow_factor).
    y1 = [btd_half_fwd(f, rz) for f, rz in zip(factors.btd, rz_s)]
    raug = jnp.concatenate([rw_s, jnp.zeros(nr, rw_s.dtype)])
    for W, y in zip(factors.W, y1):
        raug = raug - jnp.einsum("kma,km->a", W, y)

    r1 = raug[:nw]
    r2 = raug[nw:]
    # y-first quasi-definite 2-block solve: S = [[S11, S12],
    # [S12^T, S22]] with S22 = -(L22 L22^T) and the w-Schur
    # S11 - S12 S22^-1 S12^T = L11 L11^T.
    if nr:
        t2 = -_cho_apply(factors.L22, r2)           # S22^-1 r2
        u1 = _cho_apply(factors.L11, r1 - factors.S12 @ t2)
        u2 = -_cho_apply(factors.L22, r2 - factors.S12.T @ u1)
        uaug = jnp.concatenate([u1, u2])
    else:
        u1 = _cho_apply(factors.L11, r1)
        uaug = u1
    # Backward pass: uz = L_T^-T (y1 - W u).
    uz = [btd_half_bwd(f, y - W @ uaug)
          for f, y, W in zip(factors.btd, y1, factors.W)]

    dz = [u * d for u, d in zip(uz, factors.dz)]
    dw_out = u1 * factors.dwq
    return dz, dw_out
