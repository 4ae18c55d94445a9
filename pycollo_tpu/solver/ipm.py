"""On-device primal-dual interior-point NLP solver.

On-device replacement for the reference's IPOPT+MUMPS process boundary
(``pycollo/backend.py:1681-1711,1807-1827``): the whole solver — residuals,
derivatives (via JAX tracing), the condensed-space KKT factorization
(Cholesky, no pivoting), fraction-to-boundary and a merit line search — is
one jittable function with static shapes, so thousands of problem instances
solve simultaneously under ``vmap``/``pjit``.

Problem form (IPOPT-style, matching the reference NLP callback contract in
``pycollo/nlp.py:36-77``)::

    min  f(x)   s.t.  cl <= c(x) <= cu,   xl <= x <= xu

Rows with ``cl == cu`` are equalities; the rest get slack variables.  The
barrier subproblem is solved by Newton steps on the primal-dual system.  The
KKT system is solved in *condensed* form: with ``W = H + Sigma + dw*I``
positive definite (enforced by the inertia-free regularization loop — a
failed Cholesky shows up as NaNs and bumps ``dw``; this replaces MUMPS'
inertia detection) we factor ``W = L L^T`` and the Schur complement
``S = J W^-1 J^T + dc*I`` (also Cholesky), following the condensed-space
interior-point approach used by GPU NLP solvers (see PAPERS.md).

Defaults mirror the reference's IPOPT overrides where meaningful:
``mu_min = 1e-11`` (``pycollo/backend.py:1704-1709``), monotone
Fiacco-McCormick barrier updates.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class IPMOptions:
    tol: float = 1e-8
    max_iter: int = 200
    mu_init: float = 1e-1
    mu_min: float = 1e-11
    #: barrier update strategy: "adaptive" follows IPOPT's LOQO-style
    #: centrality rule (the reference's explicit IPOPT override,
    #: ``pycollo/backend.py:1707``); "monotone" is the Fiacco-McCormick
    #: staircase.
    mu_strategy: str = "adaptive"
    #: barrier decrease: mu <- max(tol/10, min(kappa_mu*mu, mu^theta_mu))
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    #: barrier error threshold: advance mu when E_mu <= kappa_eps * mu
    kappa_eps: float = 10.0
    tau_min: float = 0.99
    #: Armijo constant and number of backtracking halvings (evaluated as one
    #: batched trial-point sweep, no sequential loop)
    eta_armijo: float = 1e-4
    max_ls: int = 12
    #: globalization: "filter" implements the Wächter–Biegler filter line
    #: search (what IPOPT — the reference's solver — actually runs; accepts
    #: steps improving EITHER feasibility OR the barrier objective, far
    #: more permissive near saddles than a penalty merit function);
    #: "merit" is the l1-merit Armijo fallback.
    line_search: str = "filter"
    #: filter constants (IPOPT eq. 18-20 defaults)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    delta_sw: float = 1.0
    s_theta: float = 1.1
    s_phi: float = 2.3
    #: maximum retained filter entries (oldest overwritten beyond this)
    filter_size: int = 64
    #: primal (dw) and dual (dc) regularization management
    delta_w_init: float = 0.0
    delta_w_min: float = 1e-20
    delta_w_first: float = 1e-4
    delta_w_up: float = 8.0
    delta_w_down: float = 3.0
    delta_w_max: float = 1e10
    delta_c: float = 1e-8
    #: floor for the dual regularization dc = max(1e-8 * mu^(1/4),
    #: dc_floor).  The default keeps dc negligible (exact steps, f64).
    #: The mixed-precision path raises it (e.g. 1e-7): a larger dc caps
    #: the condition number of the condensed matrix at ~1/dc, which is
    #: what makes an f32 factorization + f64 iterative refinement
    #: convergent; the cost is that the final reachable KKT residual is
    #: O(dc)-limited — sized to the 1e-6 benchmark tolerance, not the
    #: 1e-10 oracle tolerance.
    dc_floor: float = 1e-12
    #: dual-regularization floor for the block-banded path.  Its
    #: Woodbury split factors K = M + G diag(1/D) G^T with the low-rank
    #: integral columns amplified by 1/D ~ 1/dc; with the dense path's
    #: negligible 1e-12 floor that term dominates M by ~1e12 at small mu
    #: and the factorization loses the Newton step entirely (measured on
    #: cart-pole: converges to 1e-4, then diverges to KKT ~4e4).  The
    #: floor must sit BELOW the convergence tolerance (the reachable KKT
    #: residual is O(dc)-limited: a 1e-6 floor left 5/8 perturbed
    #: cart-pole instances stalled at the 1e-6 tolerance, and 1e-5+
    #: converged none) but high enough to cap the amplification; 3e-7
    #: converges 8/8 in a dense-path-matching 13 iterations, with the
    #: primal-dual iterative refinement in ``solve_refine`` recovering
    #: the accuracy the regularization gives up.
    dc_floor_banded: float = 3e-7
    #: feasibility restoration (IPOPT section 3.3 analogue): when the
    #: filter line search exhausts with significant constraint
    #: violation, switch to minimizing the violation itself — the same
    #: KKT machinery with the objective gradient zeroed, the Lagrangian
    #: Hessian replaced by a proximal identity, and theta-Armijo
    #: acceptance — until the violation drops by kappa_resto.  Replaces
    #: the bare smallest-theta fallback trial.
    restoration: bool = True
    kappa_resto: float = 0.1
    #: restoration guard rails (round-4 regression fix: on the space
    #: station first-mesh NLP the round-3 restoration phase entered at
    #: theta ~ 2e-2 and then decreased theta by only ~5e-5 per iteration
    #: — the kappa_resto exit was unreachable and the solver burned all
    #: remaining iterations inside restoration; without restoration the
    #: same NLP converges in 129 iterations).  Three guards:
    #: enter only after ``resto_entry_fails`` CONSECUTIVE line-search
    #: failures (a one-off rejected step is normal filter behavior, not
    #: infeasibility); abort restoration after ``resto_stall_patience``
    #: consecutive iterations with relative theta decrease below
    #: ``resto_min_decrease`` (hand the iterate back to the main phase
    #: with a fresh filter); and never enter more than
    #: ``resto_max_entries`` times per solve (beyond that the main
    #: phase's smallest-theta fallback trial takes over, the pre-round-3
    #: behavior that converged on every oracle problem).
    resto_entry_fails: int = 2
    resto_stall_patience: int = 5
    resto_min_decrease: float = 1e-3
    resto_max_entries: int = 3
    #: inertia correction scheme: "speculative" factors the condensed
    #: matrix at several regularization levels in ONE batched call and
    #: selects the first positive-definite level per instance (no
    #: sequential retry loop — under vmap a do-while retries the WHOLE
    #: batch whenever any one instance needs escalation); "loop" is the
    #: IPOPT-style do-while.
    inertia: str = "speculative"
    #: speculative regularization levels as multipliers of the heuristic
    #: start value 0.3*dw_last (level 0 is always dw = 0); instances not
    #: positive definite at any level fall back to an escalation loop
    #: that starts above the top level — with an all-satisfied batch that
    #: loop's condition is false at entry and it costs nothing.
    #: The ladder is deliberately WIDE (geometric, ratio 32, spanning
    #: six orders of magnitude): early iterations routinely need dw far
    #: above the 0.3*dw_last heuristic, and under vmap every escalation
    #: trip refactors the WHOLE batch.  Extra ladder rungs are one more
    #: slice of the same batched factorization, cheaper than one
    #: escalation trip.
    spec_levels: tuple = (1.0, 32.0, 1024.0, 32768.0, 1048576.0)
    #: dense path only: append a delta_w_max capstone level to the
    #: speculative stack so some level always factors and the
    #: escalation while-loop becomes a true zero-trip fallback.
    #: Disabled by default: a capstone-selected ~zero step short-
    #: circuits the escalation search and measurably hurts batch
    #: convergence (47% with the narrow (1, 8, 64) ladder, 78% even
    #: with the wide one, vs 100% with the escalation loop); with the
    #: wide default ladder the escalation loop is rare enough that its
    #: batched refactor cost no longer shows up in the profile.
    spec_capstone: bool = False
    #: bound-multiplier safeguard (IPOPT's kappa_Sigma)
    kappa_sigma: float = 1e10
    #: interior projection margins for the initial point
    kappa_1: float = 1e-2
    kappa_2: float = 1e-2
    s_max: float = 100.0
    #: KKT factorization precision: "f64" (default) or "mixed" (factor
    #: the equilibrated condensed matrix in f32, refine against the f64
    #: residual).  Mixed is experimental: the condensed matrix
    #: K = W + J^T J/dc has condition number ~ 1/dc *by construction*
    #: (the rank-deficient J^T J block dominates W by 1e8+), so an f32
    #: factorization only works with a much larger dual regularization
    #: and aggressive refinement.
    kkt_precision: str = "f64"
    #: rounds of mixed-precision iterative refinement per KKT solve
    ir_rounds: int = 2
    #: dense-path step refinement: "ir" refines against the REGULARIZED
    #: KKT system (the classic scheme; reachable KKT residual is then
    #: O(dc * |lam|) because the converged step solves the dc-relaxed
    #: equalities); "gmres" runs right-preconditioned GMRES on the
    #: UNREGULARIZED 2x2 KKT system with the factored condensed matrix
    #: as the preconditioner — the same cure the structured path uses —
    #: which removes the dc accuracy wall entirely and therefore lets
    #: the mixed path run a LARGE dual regularization (dc_floor ~ 1e-6,
    #: condition number of the f32-factored matrix capped at ~1/dc)
    #: without stalling above tolerance (measured: perturbed cart-pole
    #: instance stalls at 4.4e-6 with "ir" at dc_floor=1e-7; converges
    #: below 1e-6 with "gmres").  "auto" = gmres when mixed, ir for f64.
    dense_refine: str = "auto"
    #: GMRES iterations for the dense-path coupled-KKT refinement
    dense_gmres_iters: int = 6
    #: evaluation dtype for derivative ASSEMBLY (the structural
    #: Jacobian/Hessian block sweeps): "f64" or "f32".  In "f32" mode
    #: the assembled blocks feed only the factorization and the GMRES
    #: operator (where rounding affects the convergence RATE, not the
    #: fixed point); the step rhs uses an exact f64 J^T lam from one
    #: VJP, and the iterate state, residuals, line-search trials, and
    #: the reported KKT error all stay f64, so the converged solution
    #: is still certified in f64.  Requires
    #: kkt_precision="mixed" and the dense path.
    eval_dtype: str = "f64"
    #: Krylov iterations for the structured (block-banded) step solve.
    #: The banded arrowhead factorization's nested Schur layers cancel
    #: catastrophically in a few border/low-rank directions near a
    #: solution (measured iteration-matrix spectral radius ~150 —
    #: plain iterative refinement DIVERGES there), so the structured
    #: path solves the condensed system by GMRES with the factorization
    #: as right preconditioner: the handful of bad directions contract
    #: in as many iterations and the step reaches f64 accuracy, which
    #: keeps the 1/dc-amplified dual recovery clean.
    gmres_iters: int = 10
    #: comma-separated trace-time ablation tags for performance bisection
    #: (debug only): "hess1" H:=I, "nofactor" diagonal KKT solve,
    #: "noesc" single factorization attempt (no inertia loop),
    #: "nols" fixed fraction-to-boundary step (no Armijo sweep),
    #: "nosoc" no second-order correction, "jac0" J:=0 (skips the
    #: structured Jacobian assembly), "nojtj" J^T J := 0 in K,
    #: "noir" no iterative refinement rounds.
    debug_ablate: str = ""


def _highest_precision(fn):
    """Trace every matmul of ``fn`` at "highest" precision.

    A GPU may run a float32 matmul at the default precision in TF32 (~10
    mantissa bits), and the f32 factorization of the 1/dc-conditioned
    condensed matrix of the mixed path is garbage at that precision.
    Float64 matmuls are unaffected.  Each entry point of the solver is
    wrapped whole, initial state included, so that no f32 matmul is
    traced outside the context.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


class IPMResult(NamedTuple):
    x: jnp.ndarray          # primal solution (original variables, no slacks)
    slack: jnp.ndarray      # slack values for inequality rows
    lam: jnp.ndarray        # constraint multipliers
    zl: jnp.ndarray         # lower bound multipliers (on [x; slack])
    zu: jnp.ndarray         # upper bound multipliers (on [x; slack])
    f: jnp.ndarray          # objective value at solution
    kkt_error: jnp.ndarray  # final scaled KKT error E_0
    mu: jnp.ndarray         # final barrier parameter
    iterations: jnp.ndarray
    converged: jnp.ndarray  # bool


class _State(NamedTuple):
    v: jnp.ndarray
    lam: jnp.ndarray
    zl: jnp.ndarray
    zu: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray
    dw: jnp.ndarray
    dw_last: jnp.ndarray
    it: jnp.ndarray
    e0: jnp.ndarray
    done: jnp.ndarray
    #: Wächter–Biegler filter (fixed-capacity arrays; entries store the
    #: already-reduced pair ((1-gamma_theta) theta, phi - gamma_phi theta)
    #: so membership is a plain elementwise AND-compare)
    fth: jnp.ndarray
    fph: jnp.ndarray
    fcnt: jnp.ndarray
    th_min: jnp.ndarray
    th_max: jnp.ndarray
    mu_f: jnp.ndarray
    #: feasibility-restoration mode flag + the violation at entry
    rmode: jnp.ndarray
    th_enter: jnp.ndarray
    #: consecutive line-search-failure count (restoration entry gate),
    #: consecutive restoration-stall count, and total entry count
    ls_fail: jnp.ndarray
    r_stall: jnp.ndarray
    r_ent: jnp.ndarray
    #: best-KKT-error safeguard: the iterate with the smallest scaled
    #: KKT error seen so far (returned instead of the last iterate —
    #: near-converged iterates can be DESTROYED by one late noise-
    #: amplified step that the filter accepts at tiny theta; measured
    #: on the banded cart-pole batch: e0 reaches 2e-5, then one bad
    #: multiplier update cascades to 4e4)
    be0: jnp.ndarray
    bv: jnp.ndarray
    blam: jnp.ndarray
    bzl: jnp.ndarray
    bzu: jnp.ndarray


def _interior_init(x0, xl, xu, k1, k2):
    """Project the start point strictly inside the bounds (IPOPT sec 3.6)."""
    has_l = xl > -jnp.inf
    has_u = xu < jnp.inf
    both = has_l & has_u
    pl = jnp.where(both, jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(xl)),
                                     k2 * (xu - xl)),
                   k1 * jnp.maximum(1.0, jnp.abs(xl)))
    pu = jnp.where(both, jnp.minimum(k1 * jnp.maximum(1.0, jnp.abs(xu)),
                                     k2 * (xu - xl)),
                   k1 * jnp.maximum(1.0, jnp.abs(xu)))
    x = jnp.where(has_l, jnp.maximum(x0, xl + pl), x0)
    x = jnp.where(has_u, jnp.minimum(x, xu - pu), x)
    return x


def build_ipm_solver(f_fn: Callable, c_fn: Callable,
                     xl: np.ndarray, xu: np.ndarray,
                     cl: np.ndarray, cu: np.ndarray,
                     options: IPMOptions = IPMOptions(),
                     derivatives: Optional[dict] = None):
    """Build a jittable IPM solver for one NLP family.

    ``f_fn(x, theta) -> scalar`` and ``c_fn(x, theta) -> (m,)`` must be
    JAX-traceable.  Bounds are static numpy arrays (they define the slack
    layout and masks at trace time).  Returns ``solve(x0, theta) ->
    IPMResult``; wrap in ``jax.vmap``/``jax.jit`` for batched solves.

    ``derivatives`` optionally supplies structured evaluators
    ``{"grad_f": (x, theta)->(n,), "jac_c": (x, theta)->(m, n),
    "hess_lag": (x, lam, theta)->(n, n)}`` — e.g. the transcription's
    per-node block assembly — replacing the generic whole-program AD.
    """
    xl = np.asarray(xl, dtype=float)
    xu = np.asarray(xu, dtype=float)
    cl = np.asarray(cl, dtype=float)
    cu = np.asarray(cu, dtype=float)
    n = xl.shape[0]
    m = cl.shape[0]
    eq_mask_np = np.isclose(cl, cu)
    ineq_idx = np.nonzero(~eq_mask_np)[0]
    ns = len(ineq_idx)
    nv = n + ns
    opt = options

    # Bounds on v = [x; slack].
    vl = np.concatenate([xl, cl[ineq_idx]])
    vu = np.concatenate([xu, cu[ineq_idx]])
    has_l = vl > -1e18
    has_u = vu < 1e18
    vl_f = np.where(has_l, vl, -1.0)   # placeholder values where infinite
    vu_f = np.where(has_u, vu, 1.0)
    rhs_eq = np.where(eq_mask_np, cl, 0.0)

    # Constant slack block of the constraint Jacobian: J_v = [J_c | J_s].
    J_s = np.zeros((m, ns))
    J_s[ineq_idx, np.arange(ns)] = -1.0

    from .linalg import make_spd_solver, positive_definite
    mixed = opt.kkt_precision == "mixed"
    spd_factor, spd_diag, spd_invert, spd_solve = make_spd_solver()
    fac_dtype = jnp.float32 if mixed else None
    use_gmres_dense = (opt.dense_refine == "gmres"
                       or (opt.dense_refine == "auto" and mixed))
    ev32 = opt.eval_dtype == "f32"
    if ev32 and not mixed:
        raise ValueError(
            'eval_dtype="f32" requires kkt_precision="mixed" (the f64 '
            'factorization path would promote the f32 blocks back).')
    ablate = frozenset(t for t in opt.debug_ablate.split(",") if t)

    derivatives = derivatives or {}
    grad_f = derivatives.get("grad_f") or jax.grad(f_fn)
    jac_c = derivatives.get("jac_c") or (
        jax.jacfwd(c_fn) if n <= 4 * m else jax.jacrev(c_fn))

    def lagrangian(x, lam, theta):
        return f_fn(x, theta) + c_fn(x, theta) @ lam

    hess_lag = derivatives.get("hess_lag") \
        or jax.hessian(lagrangian, argnums=0)

    jnp_vl = jnp.asarray(vl_f)
    jnp_vu = jnp.asarray(vu_f)
    jnp_has_l = jnp.asarray(has_l)
    jnp_has_u = jnp.asarray(has_u)
    jnp_Js = jnp.asarray(J_s)
    jnp_rhs_eq = jnp.asarray(rhs_eq)
    eq_mask = jnp.asarray(eq_mask_np)

    def g_fn(v, theta):
        """Equality-form residual g(v) = c(x) - slack/rhs.

        Dtype-polymorphic: theta's dtype governs (f32 trial sweeps pass
        an f32 theta; the residual island passes the f64 one)."""
        dt = theta.dtype
        v = v.astype(dt)
        x = v[:n]
        cx = c_fn(x, theta)
        slack_full = jnp.zeros(m, dt).at[ineq_idx].set(v[n:]) if ns \
            else jnp.zeros(m, dt)
        return cx - slack_full - jnp_rhs_eq.astype(dt)

    def dists(v):
        dl = jnp.where(jnp_has_l, v - jnp_vl.astype(v.dtype), 1.0)
        du = jnp.where(jnp_has_u, jnp_vu.astype(v.dtype) - v, 1.0)
        return dl, du

    def barrier(v, mu):
        dl, du = dists(v)
        bl = jnp.where(jnp_has_l, jnp.log(jnp.maximum(dl, 1e-300)), 0.0)
        bu = jnp.where(jnp_has_u, jnp.log(jnp.maximum(du, 1e-300)), 0.0)
        feas = jnp.all(jnp.where(jnp_has_l, dl, 1.0) > 0.0) \
            & jnp.all(jnp.where(jnp_has_u, du, 1.0) > 0.0)
        val = -mu * (jnp.sum(bl) + jnp.sum(bu))
        return jnp.where(feas, val, jnp.inf)

    def merit(v, mu, nu, theta):
        v = v.astype(theta.dtype)
        x = v[:n]
        return f_fn(x, theta) + barrier(v, mu) \
            + nu * jnp.sum(jnp.abs(g_fn(v, theta)))

    def kkt_error_pre(gf, Jtlam, rg, v, lam, zl, zu, mu):
        """Scaled KKT error (IPOPT eq. 5) from precomputed derivatives.

        ``Jtlam = Jc^T lam`` — supplied either from an explicit Jacobian
        (dense path) or a VJP (matrix-free structured path)."""
        rd_x = gf + Jtlam
        rd_s = -lam[ineq_idx] if ns else jnp.zeros(0)
        rd = jnp.concatenate([rd_x, rd_s]) - zl + zu
        dl, du = dists(v)
        compl_l = jnp.where(jnp_has_l, dl * zl - mu, 0.0)
        compl_u = jnp.where(jnp_has_u, du * zu - mu, 0.0)
        zsum = jnp.sum(jnp.abs(zl)) + jnp.sum(jnp.abs(zu))
        lsum = jnp.sum(jnp.abs(lam))
        sd = jnp.maximum(opt.s_max,
                         (lsum + zsum) / max(m + 2 * nv, 1)) / opt.s_max
        sc = jnp.maximum(opt.s_max, zsum / max(2 * nv, 1)) / opt.s_max
        e = jnp.maximum(jnp.max(jnp.abs(rd)) / sd,
                        jnp.max(jnp.abs(rg)) if m else 0.0)
        e = jnp.maximum(e, jnp.maximum(
            jnp.max(jnp.abs(compl_l)) / sc if nv else 0.0,
            jnp.max(jnp.abs(compl_u)) / sc if nv else 0.0))
        return e

    def kkt_error(v, lam, zl, zu, mu, theta):
        """KKT error with fresh derivative evaluation (debug/result use)."""
        x = v[:n]
        _, c_vjp = jax.vjp(lambda xx: c_fn(xx, theta), x)
        return kkt_error_pre(grad_f(x, theta), c_vjp(lam)[0],
                             g_fn(v, theta), v, lam, zl, zu, mu)

    def compute_step(v, lam, zl, zu, mu, dw_last, theta, gf, Jc, rg,
                     restore=False, Jtlam64=None):
        """Condensed-space Newton step via two Cholesky factorizations.

        Runs the IPOPT-style inertia-correction loop *inside* one call: a
        non-positive-definite ``W`` makes the Cholesky factor NaN, which
        triggers an escalation of the primal regularization ``dw`` and an
        immediate refactorization (no pivoting or inertia counts needed —
        this replaces MUMPS' inertia detection).

        ``restore``: feasibility-restoration mode — the caller passes
        ``gf = 0`` and the Lagrangian Hessian is swapped for a proximal
        identity, turning the step into damped Gauss-Newton on the
        constraint violation (IPOPT section 3.3 analogue).
        """
        x = v[:n]
        if ev32:
            th_h = theta.astype(jnp.float32)
            H = jnp.eye(n, dtype=jnp.float32) if "hess1" in ablate \
                else hess_lag(x.astype(jnp.float32),
                              lam.astype(jnp.float32), th_h)
            H = jnp.where(restore, jnp.eye(n, dtype=jnp.float32), H)
        else:
            H = jnp.eye(n) if "hess1" in ablate \
                else hess_lag(x, lam, theta)
            H = jnp.where(restore, jnp.eye(n), H)
        dl, du = dists(v)
        sig_l = jnp.where(jnp_has_l, zl / dl, 0.0)
        sig_u = jnp.where(jnp_has_u, zu / du, 0.0)
        mu_dl = jnp.where(jnp_has_l, mu / dl, 0.0)
        mu_du = jnp.where(jnp_has_u, mu / du, 0.0)

        W0 = jnp.zeros((nv, nv)).at[:n, :n].set(H)
        W0 = W0 + jnp.diag(sig_l + sig_u)
        # In eval_dtype="f32" mode Jc arrives f32 and is only the
        # OPERATOR (factorization + GMRES matvecs, where rounding only
        # affects the convergence rate); the step rhs uses the exact
        # f64 J^T lam from a VJP (Jtlam64) so the Newton fixed point is
        # the true KKT point — with the rounded J in the rhs the
        # iteration measurably stalls at ~1e-4.
        Jc64 = Jc.astype(v.dtype)
        J = jnp.concatenate([Jc64, jnp_Js], axis=1)   # (m, nv)

        rd_x = gf + (Jc64.T @ lam if Jtlam64 is None else Jtlam64)
        rd_s = -lam[ineq_idx] if ns else jnp.zeros(0)
        rd = jnp.concatenate([rd_x, rd_s]) - mu_dl + mu_du
        eye_nv = jnp.eye(nv)

        # Dual regularization: relaxes equality rows so the condensed matrix
        # K = W + J^T J / dc is positive definite under SOSC (MadNLP-style
        # "LDL-free" condensed-space KKT; see PAPERS.md).  Shrinks with mu
        # so it does not limit final accuracy.
        dc = jnp.maximum(1e-8 * jnp.sqrt(jnp.sqrt(mu)), opt.dc_floor)
        # The condensed matrix K is only ever *factored* — every residual
        # in the refinement loop below is computed from W0/J/dc directly.
        # In mixed mode the O(nv^2 m) JtJ product and the O(nv^3)
        # factorization therefore run in f32, while step accuracy is
        # restored by f64 iterative refinement.
        if mixed:
            J_fc = J.astype(fac_dtype)
            JtJ_f = J_fc.T @ J_fc
            W0_fc = W0.astype(fac_dtype)
            eye_f = jnp.eye(nv, dtype=fac_dtype)
        else:
            J_fc = J
            JtJ_f = J.T @ J
            W0_fc = W0
            eye_f = eye_nv
        if "nojtj" in ablate:
            JtJ_f = jnp.zeros_like(JtJ_f)

        # Base condensed matrix (dw = 0); regularized variants add dw*I.
        K0_f = W0_fc + JtJ_f / dc.astype(JtJ_f.dtype)

        def equil_factor(Kmat):
            """Jacobi-equilibrated Cholesky of one or a stack of K's.

            Symmetric equilibration K' = D K D with D = diag(K)^-1/2:
            near the solution the diagonal of K spans ~20 orders of
            magnitude (Sigma ~ z/d at active bounds plus the 1/dc
            penalty block), which breaks an unpivoted f64 Cholesky long
            before K is truly indefinite — equilibration bounds factor
            growth by the *scaled* condition number, the stability role
            pivoting plays inside MUMPS in the reference stack.
            """
            dK = jnp.sqrt(jnp.clip(
                jnp.diagonal(Kmat, axis1=-2, axis2=-1), 1e-30, jnp.inf))
            Ks = Kmat / dK[..., :, None] / dK[..., None, :]
            if "nofactor" in ablate:
                factors_ = jax.tree_util.tree_map(
                    lambda s: jnp.zeros(s.shape, s.dtype),
                    jax.eval_shape(spd_factor, Ks))
            else:
                factors_ = spd_factor(Ks)
            # Indefiniteness detection: NaN or near-zero pivots.
            return factors_, dK, positive_definite(spd_diag(factors_))

        def solve_with(factors_, dK64, dw):
            """KKT solve + f64 refinement on given factors.

            Two refinement schemes (``opt.dense_refine``): classic IR
            against the dc-regularized system, or right-preconditioned
            GMRES on the UNREGULARIZED coupled KKT system — exact f64
            matvecs, factored-condensed preconditioner — which removes
            the O(dc*|lam|) accuracy wall of the regularized solve (the
            dense-path analogue of the structured path's
            ``solve_refine``)."""
            def ksolve(rhs):
                if "nofactor" in ablate:
                    return rhs / (dK64 * dK64)
                z = spd_solve(factors_, (rhs / dK64).astype(
                    fac_dtype or v.dtype))
                return z.astype(v.dtype) / dK64

            if use_gmres_dense and "noir" not in ablate:
                # Coupled-KKT GMRES entirely in the factorization dtype
                # (f32 in mixed mode): the refinement only needs accuracy
                # RELATIVE to the step (inexact-Newton forcing term ~
                # 1e-6), while the f64-evaluated rhs (rd, rg) pins the
                # outer fixed point exactly — so none of the ~30 matvecs
                # per step needs f64.
                from .krylov import gmres_right
                fdt = fac_dtype or v.dtype
                dK_f = dK64.astype(fdt)
                dc_f = dc.astype(fdt)
                dw_f = dw.astype(fdt)

                def ksolve_f(rhs):
                    if "nofactor" in ablate:
                        return rhs / (dK_f * dK_f)
                    return spd_solve(factors_, rhs / dK_f) / dK_f

                def prec(r):
                    r1 = r[:nv]
                    r2 = r[nv:]
                    dv_ = ksolve_f(r1 + J_fc.T @ (r2 / dc_f))
                    return jnp.concatenate(
                        [dv_, (J_fc @ dv_ - r2) / dc_f])

                def amul(wv):
                    dv_ = wv[:nv]
                    dl_ = wv[nv:]
                    return jnp.concatenate(
                        [W0_fc @ dv_ + dw_f * dv_ + J_fc.T @ dl_,
                         J_fc @ dv_])

                rhs_f = jnp.concatenate([-rd, -rg]).astype(fdt)
                sol = gmres_right(amul, prec, rhs_f,
                                  opt.dense_gmres_iters)
                dv = sol[:nv].astype(v.dtype)
                dlam = sol[nv:].astype(v.dtype)
            else:
                rhs1 = -(rd + J.T @ (rg / dc))
                dv = ksolve(rhs1)
                dlam = (J @ dv + rg) / dc
                # Iterative refinement on the regularized KKT residual
                # (always f64) cleans up the 1/dc amplification of
                # roundoff and, in mixed mode, f32 factorization error.
                for _ in range(0 if "noir" in ablate else opt.ir_rounds):
                    res1 = -rd - (W0 @ dv + dw * dv + J.T @ dlam)
                    res2 = -rg - (J @ dv - dc * dlam)
                    ev = ksolve(res1 + J.T @ (res2 / dc))
                    dv = dv + ev
                    dlam = dlam + (J @ ev - res2) / dc
            solved_ok = ~(jnp.any(jnp.isnan(dv)) | jnp.any(jnp.isinf(dv))
                          | jnp.any(jnp.isnan(dlam)))
            return dv, dlam, solved_ok

        def attempt(dw):
            K = K0_f + dw.astype(K0_f.dtype) * eye_f
            factors_, dK, lvl_ok = equil_factor(K)
            Linv = spd_invert(factors_)
            dK64 = dK.astype(v.dtype)
            dv, dlam, solved_ok = solve_with(Linv, dK64, dw)
            return dv, dlam, lvl_ok & solved_ok, (Linv, dK64)

        # Inertia-correction escalation as a do-while with a single copy
        # of the factorization program (keeps the compiled program small;
        # the first trip runs with dw = 0).
        def esc_cond(carry):
            dw, _, _, ok, k, _ = carry
            return (~ok) & (k < 30)

        def esc_body(carry):
            dw, dv, dlam, ok, k, factors = carry
            dw_next = jnp.where(
                k == 0, jnp.asarray(0.0, v.dtype),
                jnp.where(dw == 0.0,
                          jnp.maximum(opt.delta_w_min, 0.3 * dw_last),
                          dw * opt.delta_w_up))
            dw_next = jnp.minimum(dw_next, opt.delta_w_max)
            dv, dlam, ok, factors = attempt(dw_next)
            return (dw_next, dv, dlam, ok, k + 1, factors)

        if "noesc" in ablate:
            dw_used = jnp.asarray(0.0, v.dtype)
            dv, dlam, ok, factors = attempt(dw_used)
            dw_op = dw_used
        elif opt.inertia == "speculative":
            # Speculative multi-level inertia correction: factor K at
            # dw in {0, spec_levels * 0.3*dw_last, delta_w_max} in ONE
            # batched call and keep the first positive-definite level.
            # Replaces the do-while retry: under vmap a retry by ANY
            # instance refactors the WHOLE batch, while the stacked
            # factorization amortizes into the same batched call.
            dw1 = jnp.maximum(opt.delta_w_min, 0.3 * dw_last)
            dws = jnp.stack(
                [jnp.zeros_like(dw1)]
                + [jnp.minimum(m_ * dw1, opt.delta_w_max)
                   for m_ in opt.spec_levels]
                + ([jnp.full_like(dw1, opt.delta_w_max)]
                   if opt.spec_capstone else []))
            K_all = K0_f[None] \
                + dws[:, None, None].astype(K0_f.dtype) * eye_f[None]
            fac_all, dK_all, lvl_ok = equil_factor(K_all)
            lvl = jnp.argmax(lvl_ok)
            any_lvl = jnp.any(lvl_ok)
            # Only the selected level is inverted for the solves.
            Linv = spd_invert(jax.tree_util.tree_map(lambda a: a[lvl],
                                                     fac_all))
            dK64 = dK_all[lvl].astype(v.dtype)
            dw_spec = dws[lvl]
            dv, dlam, solved_ok = solve_with(Linv, dK64, dw_spec)
            ok0 = any_lvl & solved_ok
            # Escalation fallback above the top speculative level for the
            # (rare) instances that are still indefinite; zero-trip when
            # the whole batch is satisfied.
            init = (dws[-1], dv, dlam, ok0, jnp.asarray(1, jnp.int32),
                    (Linv, dK64))
            dw_esc, dv, dlam, ok, _, factors = jax.lax.while_loop(
                esc_cond, esc_body, init)
            # Actual dw of the SELECTED factors (fed to the corrector's
            # exact KKT operator) vs the value reported to the dw_last
            # heuristic: the capstone level must not ratchet dw_last to
            # delta_w_max (all subsequent ladders would collapse to
            # {0, 1e10}); report one delta_w_up step above the top
            # regular level instead so the ladder keeps growing
            # geometrically across iterations.
            dw_op = jnp.where(ok0, dw_spec, dw_esc)
            dw_rep = dw_spec
            if opt.spec_capstone:
                dw_rep = jnp.where(
                    lvl == dws.shape[0] - 1,
                    jnp.minimum(opt.delta_w_up * dws[-2],
                                opt.delta_w_max),
                    dw_spec)
            dw_used = jnp.where(ok0, dw_rep, dw_esc)
        else:
            zero_factors = jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype),
                jax.eval_shape(
                    lambda: attempt(jnp.asarray(0.0, v.dtype))[3]))
            init = (jnp.asarray(0.0, v.dtype), jnp.zeros(nv),
                    jnp.zeros(m), jnp.asarray(False),
                    jnp.asarray(0, jnp.int32), zero_factors)
            dw_used, dv, dlam, ok, _, factors = jax.lax.while_loop(
                esc_cond, esc_body, init)
            dw_op = dw_used
        dzl = jnp.where(jnp_has_l, mu_dl - zl - sig_l * dv, 0.0)
        dzu = jnp.where(jnp_has_u, mu_du - zu + sig_u * dv, 0.0)
        # Sigma ~ kappa*mu/d^2 can overflow for near-boundary iterates
        # even when dv itself is finite; a non-finite dual displacement
        # must mark the step failed (0 * inf = NaN otherwise poisons z).
        ok = ok & jnp.all(jnp.isfinite(dzl)) & jnp.all(jnp.isfinite(dzu))
        # Directional derivative of the barrier objective along dv.
        step_dir = gf @ dv[:n] - jnp.sum(mu_dl * dv) + jnp.sum(mu_du * dv)

        def corrector(rg_soc):
            """Solve the KKT system with rhs (0, rg_soc) using the
            existing (equilibrated) factorization (for second-order
            corrections)."""
            fac, dK64_ = factors

            def ksolve_c(rhs):
                if "nofactor" in ablate:
                    return rhs / (dK64_ * dK64_)
                z = spd_solve(fac, (rhs / dK64_).astype(
                    fac_dtype or v.dtype))
                return z.astype(v.dtype) / dK64_

            if use_gmres_dense and "noir" not in ablate:
                # Same coupled-KKT GMRES as the main step (shorter, in
                # the factorization dtype): a raw regularized solve
                # leaves an O(dc*|lam|) bias that the 1/dc dual recovery
                # amplifies into the multipliers whenever the SOC
                # candidate is accepted.
                from .krylov import gmres_right
                fdt = fac_dtype or v.dtype
                dK_f = dK64_.astype(fdt)
                dc_f = dc.astype(fdt)
                dw_f = dw_op.astype(fdt)

                def ksolve_f(rhs):
                    if "nofactor" in ablate:
                        return rhs / (dK_f * dK_f)
                    return spd_solve(fac, rhs / dK_f) / dK_f

                def prec(r):
                    r1 = r[:nv]
                    r2 = r[nv:]
                    dv_ = ksolve_f(r1 + J_fc.T @ (r2 / dc_f))
                    return jnp.concatenate(
                        [dv_, (J_fc @ dv_ - r2) / dc_f])

                def amul(wv):
                    dv_ = wv[:nv]
                    dl_ = wv[nv:]
                    return jnp.concatenate(
                        [W0_fc @ dv_ + dw_f * dv_ + J_fc.T @ dl_,
                         J_fc @ dv_])

                sol = gmres_right(
                    amul, prec,
                    jnp.concatenate(
                        [jnp.zeros(nv, fdt), -rg_soc.astype(fdt)]),
                    max(3, opt.dense_gmres_iters // 2))
                return (sol[:nv].astype(v.dtype),
                        sol[nv:].astype(v.dtype))
            dv_c = ksolve_c(-(J.T @ (rg_soc / dc)))
            dlam_c = (J @ dv_c + rg_soc) / dc
            return dv_c, dlam_c

        return dv, dlam, dzl, dzu, step_dir, dw_used, ok, corrector

    kkt = derivatives.get("kkt")

    def compute_step_structured(v, lam, zl, zu, mu, dw_last, theta, gf,
                                rg, Jtlam, c_vjp, restore=False):
        """Newton step via the block-banded arrowhead KKT factorization.

        Matrix-free counterpart of :func:`compute_step`: slacks are
        eliminated analytically (per-row dual regularization
        ``D_i = dc + 1/sigma_s_i``), the condensed system over the
        original variables is factored in banded-arrowhead form
        (``solver/banded.py``), and all residual algebra uses JVP/VJP
        closures — no dense Jacobian or Hessian is ever materialized.
        This is the ``linear_solver = "block-banded"`` path, replacing
        the reference's MUMPS factorization
        (``pycollo/backend.py:1695-1711``) with O(N) structure.
        """
        x = v[:n]
        dl, du = dists(v)
        sig_l = jnp.where(jnp_has_l, zl / dl, 0.0)
        sig_u = jnp.where(jnp_has_u, zu / du, 0.0)
        sig = sig_l + sig_u
        mu_dl = jnp.where(jnp_has_l, mu / dl, 0.0)
        mu_du = jnp.where(jnp_has_u, mu / du, 0.0)
        sig_x = sig[:n]
        sig_s = jnp.maximum(sig[n:], 1e-300)
        rd_x = gf + Jtlam - mu_dl[:n] + mu_du[:n]
        rd_s = (-lam[ineq_idx] - mu_dl[n:] + mu_du[n:]) if ns \
            else jnp.zeros(0)
        # Floor coupled to the tolerance (advisor round-3 finding): the
        # reachable KKT residual is O(dc)-limited through the relaxed
        # equality rows, so an unconditional 3e-7 floor walls off the
        # default 1e-8 tolerance.  With the GMRES step refinement the
        # Woodbury 1/dc amplification no longer needs a large floor
        # (measured: cart-pole batch converges 8/8 to 1e-8 at floor
        # 1e-9, in FEWER iterations than at 3e-7).
        floor_b = min(opt.dc_floor_banded, 0.1 * opt.tol)
        dc = jnp.maximum(1e-8 * jnp.sqrt(jnp.sqrt(mu)),
                         jnp.maximum(opt.dc_floor, floor_b))
        # Slack elimination: constraint row i gets dual regularization
        # D_i = dc (+ 1/sigma_s_i on inequality rows), and the modified
        # residual g~ = rg + rd_s / sigma_s.
        if ns:
            Dinv_ineq = 1.0 / (dc + 1.0 / sig_s)
            Dinv = jnp.where(eq_mask, 1.0 / dc,
                             jnp.zeros(m).at[ineq_idx].set(Dinv_ineq))
            gtil = rg + jnp.zeros(m).at[ineq_idx].set(rd_s / sig_s)
        else:
            Dinv = jnp.full(m, 1.0) / dc
            gtil = rg
        # Restoration mode: zero the Hessian multipliers (-> per-node
        # blocks vanish) and add a proximal identity through the barrier
        # diagonal, giving damped Gauss-Newton on the violation.
        lam_h = jnp.where(restore, 0.0, 1.0) * lam
        sig_x_h = sig_x + jnp.where(restore, 1.0, 0.0)
        blocks_e, blocks_c = kkt.assemble(x, theta, lam_h, sig_x_h, Dinv)
        rhs = -(rd_x + c_vjp(Dinv * gtil)[0])

        def c_jvp(dxx):
            return jax.jvp(lambda xx: c_fn(xx, theta), (x,), (dxx,))[1]

        def solve_refine(blocks, fac, dw, rhs_v):
            """Krylov-accurate step solve on the selected KKT variant.

            The factored banded operator is only a PRECONDITIONER: its
            nested Schur layers cancel catastrophically in a few
            border/low-rank directions near a solution (measured
            iteration-matrix spectral radius ~150 at a near-converged
            cart-pole iterate — plain iterative refinement diverges),
            while the assembled matvec ``kkt.kmul`` is exact to 1e-15
            against the dense condensed matrix.  GMRES with the exact
            matvec and the factored solve as right preconditioner
            contracts the outlier directions in a handful of iterations
            and delivers an f64-grade dx, which keeps the
            ``Dinv ~ 1/dc``-amplified dual recovery
            ``dlam = Dinv (J dx + g~)`` clean (1e-2-scale multiplier
            noise otherwise destroys near-converged iterates).
            """
            if "noir" in ablate:
                dxx = kkt.solve(blocks, fac, rhs_v)
            else:
                from .krylov import gmres_right
                dxx = gmres_right(
                    lambda z: kkt.kmul(blocks, dw, z),
                    lambda r: kkt.solve(blocks, fac, r),
                    rhs_v, opt.gmres_iters)
            dlm = Dinv * (c_jvp(dxx) + gtil)
            return dxx, dlm

        # Speculative multi-level inertia correction (see the dense
        # path's rationale): factor at several dw levels in one batched
        # call, keep the first positive-definite level.  The LAST level
        # swaps the exact Lagrangian Hessian for its per-node PSD
        # projection at dw ~ 0 (modified Newton): the banded M-block
        # must be PD — strictly stronger than the dense path's K > 0 —
        # and on problems where M is structurally indefinite near the
        # solution (active integral constraints), escalating dw past
        # O(10) destroys the Newton step; the convexified level stays
        # well-posed with an O(mu)-sized perturbation instead.
        dw1 = jnp.maximum(opt.delta_w_min, 0.3 * dw_last)
        dws = jnp.stack([jnp.zeros_like(dw1)]
                        + [jnp.minimum(m_ * dw1, opt.delta_w_max)
                           for m_ in opt.spec_levels]
                        + [jnp.full_like(dw1, 1e-10)])
        n_exact = 1 + len(opt.spec_levels)
        blocks_lv = jax.tree_util.tree_map(
            lambda e, c: jnp.stack([e] * n_exact + [c]),
            blocks_e, blocks_c)
        facs = jax.vmap(kkt.factor)(blocks_lv, dws)
        lvl = jnp.argmax(facs.ok)
        any_lvl = jnp.any(facs.ok)
        fac_sel = jax.tree_util.tree_map(lambda a: a[lvl], facs)
        blocks_sel = jax.tree_util.tree_map(lambda a: a[lvl], blocks_lv)
        dw_spec = dws[lvl]
        dx, dlam = solve_refine(blocks_sel, fac_sel, dw_spec, rhs)
        ok0 = any_lvl & jnp.all(jnp.isfinite(dx)) \
            & jnp.all(jnp.isfinite(dlam))
        # Only exact-level successes feed the dw heuristic; a convexified
        # fallback must not inflate the next iteration's start level.
        dw_heur = jnp.where(lvl < n_exact, dw_spec, 0.0)

        # Escalation fallback above the top speculative level (zero-trip
        # when the batch is satisfied) — escalates the CONVEXIFIED
        # blocks, which become PD at modest dw by construction.
        def esc_cond(carry):
            dw, _, _, ok, k, _ = carry
            return (~ok) & (k < 30)

        def esc_body(carry):
            dw, dxc, dlc, ok, k, _ = carry
            dw_next = jnp.minimum(
                jnp.maximum(dw * opt.delta_w_up, opt.delta_w_min),
                opt.delta_w_max)
            fac = kkt.factor(blocks_c, dw_next)
            dxn, dln = solve_refine(blocks_c, fac, dw_next, rhs)
            okn = fac.ok & jnp.all(jnp.isfinite(dxn)) \
                & jnp.all(jnp.isfinite(dln))
            return (dw_next, dxn, dln, okn, k + 1, fac)

        dw_esc, dx, dlam, ok, _, fac_fin = jax.lax.while_loop(
            esc_cond, esc_body,
            (jnp.maximum(dws[n_exact - 1], 1e-8), dx, dlam, ok0,
             jnp.asarray(1, jnp.int32), fac_sel))
        esc_taken = ~ok0
        # dw of the factors actually in use (exact operator for the SOC
        # corrector) vs the value fed to the dw_last heuristic — a
        # convexified-level success must not inflate the next ladder.
        dw_op = jnp.where(ok0, dw_spec, dw_esc)
        dw_used = jnp.where(ok0, dw_heur, dw_esc)
        fac_fin = jax.tree_util.tree_map(
            lambda a, b: jnp.where(ok0, a, b), fac_sel, fac_fin)
        blocks_fin = jax.tree_util.tree_map(
            lambda s, c: jnp.where(esc_taken, c, s), blocks_sel, blocks_c)

        ds = (dlam[ineq_idx] - rd_s) / sig_s if ns else jnp.zeros(0)
        dv = jnp.concatenate([dx, ds])
        dzl = jnp.where(jnp_has_l, mu_dl - zl - sig_l * dv, 0.0)
        dzu = jnp.where(jnp_has_u, mu_du - zu + sig_u * dv, 0.0)
        ok = ok & jnp.all(jnp.isfinite(dzl)) & jnp.all(jnp.isfinite(dzu))
        step_dir = gf @ dx - jnp.sum(mu_dl * dv) + jnp.sum(mu_du * dv)

        def corrector(rg_soc):
            rhs_c = -c_vjp(Dinv * rg_soc)[0]
            # Same Krylov treatment as the main step: a raw factored
            # solve can be off by orders of magnitude in the border
            # directions, and a garbage SOC candidate passes the
            # filter's phi test at tiny theta just like a garbage step.
            if "noir" in ablate:
                dx_c = kkt.solve(blocks_fin, fac_fin, rhs_c)
            else:
                from .krylov import gmres_right
                dx_c = gmres_right(
                    lambda z: kkt.kmul(blocks_fin, dw_op, z),
                    lambda r: kkt.solve(blocks_fin, fac_fin, r),
                    rhs_c, max(4, opt.gmres_iters // 2))
            dlam_c = Dinv * (c_jvp(dx_c) + rg_soc)
            ds_c = dlam_c[ineq_idx] / sig_s if ns else jnp.zeros(0)
            return jnp.concatenate([dx_c, ds_c]), dlam_c

        return dv, dlam, dzl, dzu, step_dir, dw_used, ok, corrector

    def ftb_primal(v, disp, mu):
        """Largest step fraction keeping v + a*disp interior (tau rule)."""
        tau = jnp.maximum(opt.tau_min, 1.0 - mu)
        dl, du = dists(v)
        a_l = jnp.where(jnp_has_l & (disp < 0),
                        -tau * dl / jnp.minimum(disp, -1e-300), jnp.inf)
        a_u = jnp.where(jnp_has_u & (disp > 0),
                        tau * du / jnp.maximum(disp, 1e-300), jnp.inf)
        return jnp.minimum(1.0, jnp.minimum(jnp.min(a_l), jnp.min(a_u)))

    def ftb_dual(zl, zu, dzl, dzu, mu):
        tau = jnp.maximum(opt.tau_min, 1.0 - mu)
        b_l = jnp.where(jnp_has_l & (dzl < 0),
                        -tau * zl / jnp.minimum(dzl, -1e-300), jnp.inf)
        b_u = jnp.where(jnp_has_u & (dzu < 0),
                        -tau * zu / jnp.minimum(dzu, -1e-300), jnp.inf)
        return jnp.minimum(1.0, jnp.minimum(jnp.min(b_l), jnp.min(b_u)))

    def line_search(v, dv, dlam, mu, nu, alpha_max, gf_dv, corrector,
                    theta, g0, f0):
        """Armijo backtracking as one batched trial sweep, plus a
        second-order correction (SOC) candidate at the full step.

        The SOC re-solves the KKT system with the constraint residual of
        the full trial point (factorization reused), curing the
        curvature-induced rejection of full Newton steps on stiff
        transcriptions (the Maratos effect) the same way IPOPT does.
        Returns the *effective* primal and multiplier displacements.
        """
        if "nols" in ablate:
            return (alpha_max * dv, alpha_max * dlam, alpha_max,
                    jnp.asarray(True))
        phi0 = f0 + barrier(v, mu) + nu * jnp.sum(jnp.abs(g0))
        dphi = gf_dv - nu * jnp.sum(jnp.abs(g0))
        dphi = jnp.minimum(dphi, 0.0)
        alphas = alpha_max * (0.5 ** jnp.arange(opt.max_ls))
        phis = jax.vmap(lambda a: merit(v + a * dv, mu, nu, theta))(alphas)
        ok = phis <= phi0 + opt.eta_armijo * alphas * dphi
        any_ok = jnp.any(ok)
        first = jnp.argmax(ok)
        alpha_plain = jnp.where(any_ok, alphas[first], alphas[-1])

        if "nosoc" in ablate:
            alpha_plain_eff = jnp.where(any_ok, alphas[first], alphas[-1])
            return (alpha_plain_eff * dv, alpha_plain_eff * dlam,
                    alpha_plain_eff, any_ok)
        # SOC candidate from the full-step constraint residual.
        g_trial = g_fn(v + alpha_max * dv, theta)
        dv_c, dlam_c = corrector(alpha_max * g0 + g_trial)
        soc_bad = jnp.any(jnp.isnan(dv_c))
        dv_c = jnp.where(soc_bad, 0.0, dv_c)
        dlam_c = jnp.where(soc_bad, 0.0, dlam_c)
        disp = alpha_max * dv + dv_c
        beta = ftb_primal(v, disp, mu)
        phi_soc = merit(v + beta * disp, mu, nu, theta)
        soc_ok = (phi_soc <= phi0 + opt.eta_armijo * beta * alpha_max
                  * dphi) & (~soc_bad)
        use_soc = soc_ok & (beta * alpha_max > alpha_plain) \
            & (~ok[0])   # full plain step already fine -> no SOC needed
        dv_eff = jnp.where(use_soc, beta * disp, alpha_plain * dv)
        dlam_eff = jnp.where(use_soc,
                             beta * (alpha_max * dlam + dlam_c),
                             alpha_plain * dlam)
        alpha_rep = jnp.where(use_soc, beta * alpha_max, alpha_plain)
        return dv_eff, dlam_eff, alpha_rep, any_ok | soc_ok

    def update_nu(nu, g0, gf_dv):
        """Merit penalty update (IPOPT eq. 3.5 with rho = 0.1)."""
        g1 = jnp.sum(jnp.abs(g0))
        nu_trial = gf_dv / jnp.maximum(0.9 * g1, 1e-12) + 1.0
        return jnp.clip(jnp.maximum(nu, nu_trial), 0.0, 1e10)

    FSZ = max(1, min(opt.filter_size, opt.max_iter + 1))

    def theta_phi(v_t, mu, theta):
        """(constraint violation, barrier objective) of a trial point.

        theta's dtype governs the evaluation precision (f32 in
        eval_dtype="f32" mode — acceptance decisions never need 1e-6
        resolution; the f64 KKT island certifies convergence)."""
        v_t = v_t.astype(theta.dtype)
        th = jnp.sum(jnp.abs(g_fn(v_t, theta)))
        ph = f_fn(v_t[:n], theta) + barrier(v_t, mu)
        return th, ph

    def filter_line_search(state: _State, dv, dlam, alpha_max, dphi,
                           corrector, theta, g0, f0):
        """Wächter–Biegler filter backtracking (IPOPT Algorithm A, the
        reference solver's actual globalization) as one batched trial
        sweep plus a second-order-correction candidate.

        Returns (dv_eff, dlam_eff, alpha, ls_ok, fth, fph, fcnt) — the
        effective displacements and the augmented filter.
        """
        v, mu = state.v, state.mu
        fth, fph, fcnt = state.fth, state.fph, state.fcnt
        th0 = jnp.sum(jnp.abs(g0))
        ph0 = f0 + barrier(v, mu)
        dphi = jnp.minimum(dphi, 0.0)

        def acceptable(th_t, ph_t, alpha_t):
            """(filter-acceptable, point-acceptable, phi-type) tests."""
            valid = jnp.arange(FSZ) < fcnt
            blocked = jnp.any((th_t >= fth) & (ph_t >= fph) & valid)
            sw = (th0 <= state.th_min) & (dphi < 0.0) \
                & (alpha_t * (-dphi) ** opt.s_phi
                   > opt.delta_sw * th0 ** opt.s_theta)
            armijo = ph_t <= ph0 + opt.eta_armijo * alpha_t * dphi
            suff = (th_t <= (1.0 - opt.gamma_theta) * th0) \
                | (ph_t <= ph0 - opt.gamma_phi * th0)
            point_ok = jnp.where(sw, armijo, suff)
            return (~blocked) & point_ok, sw & armijo

        alphas = alpha_max * (0.5 ** jnp.arange(opt.max_ls))

        def trial(a):
            th_t, ph_t = theta_phi(v + a * dv, mu, theta)
            ok, phi_type = acceptable(th_t, ph_t, a)
            return ok, phi_type, th_t
        ok_k, phi_k, th_k = jax.vmap(trial)(alphas)
        any_ok = jnp.any(ok_k)
        first = jnp.argmax(ok_k)
        alpha_plain = alphas[first]
        phi_type_plain = phi_k[first]

        # SOC candidate from the full-step constraint residual (tried when
        # the full plain step was rejected and did not reduce theta).
        g_trial = g_fn(v + alpha_max * dv, theta)
        dv_c, dlam_c = corrector(alpha_max * g0 + g_trial)
        soc_bad = jnp.any(jnp.isnan(dv_c))
        dv_c = jnp.where(soc_bad, 0.0, dv_c)
        dlam_c = jnp.where(soc_bad, 0.0, dlam_c)
        disp = alpha_max * dv + dv_c
        beta = ftb_primal(v, disp, mu)
        th_soc, ph_soc = theta_phi(v + beta * disp, mu, theta)
        soc_ok, soc_phi_type = acceptable(th_soc, ph_soc,
                                          beta * alpha_max)
        use_soc = soc_ok & (~soc_bad) & (~ok_k[0]) \
            & (beta * alpha_max > jnp.where(any_ok, alpha_plain, 0.0))

        # Emergency fallback when nothing is acceptable: the trial with
        # the smallest constraint violation (a pure feasibility move —
        # the poor man's restoration phase).
        k_feas = jnp.argmin(jnp.where(jnp.isnan(th_k), jnp.inf, th_k))
        alpha_fall = alphas[k_feas]

        alpha_eff = jnp.where(any_ok, alpha_plain, alpha_fall)
        dv_eff = jnp.where(use_soc, beta * disp, alpha_eff * dv)
        dlam_eff = jnp.where(use_soc,
                             beta * (alpha_max * dlam + dlam_c),
                             alpha_eff * dlam)
        alpha_rep = jnp.where(use_soc, beta * alpha_max, alpha_eff)
        ls_ok = any_ok | use_soc

        # Filter augmentation on theta-type (non-Armijo) accepted steps
        # (IPOPT eq. 22); ring-buffer overwrite beyond capacity.
        phi_type = jnp.where(use_soc, soc_phi_type, phi_type_plain)
        augment = ls_ok & (~phi_type)
        slot = jnp.where(fcnt < FSZ, fcnt, 1 + (state.it % (FSZ - 1))
                         if FSZ > 1 else 0)
        slot = jnp.asarray(slot, jnp.int32)
        fth_n = jnp.where(augment,
                          fth.at[slot].set((1.0 - opt.gamma_theta) * th0),
                          fth)
        fph_n = jnp.where(augment,
                          fph.at[slot].set(ph0 - opt.gamma_phi * th0),
                          fph)
        fcnt_n = jnp.where(augment, jnp.minimum(fcnt + 1, FSZ), fcnt)
        return dv_eff, dlam_eff, alpha_rep, ls_ok, fth_n, fph_n, fcnt_n

    #: internal stop threshold: the running KKT error is exact f64 in
    #: every mode (eval_dtype="f32" uses an exact f64 VJP for J^T lam),
    #: so no margin is needed; the returned kkt_error and converged
    #: flag are still recomputed fresh in f64 in ev32 mode.
    tol_stop = opt.tol

    def _stop_rule(e_0, be0):
        """Converged, or the tail has exploded beyond recovery.

        The divergence test only fires once a near-solution iterate was
        seen (be0 small) and the current error is orders of magnitude
        above it — the tail-explosion signature, not the normal early-
        phase KKT-error fluctuation."""
        diverged = (be0 <= 1e-4) & (e_0 >= 1e4 * be0) & (e_0 > tol_stop)
        return (e_0 <= tol_stop) | diverged

    def body(state: _State, theta):
        v, lam, zl, zu, mu, nu = (state.v, state.lam, state.zl, state.zu,
                                  state.mu, state.nu)
        dw_last, it = state.dw_last, state.it
        # One derivative evaluation per iterate, shared by the KKT error,
        # the Newton step, and the line search.
        x = v[:n]
        gf = grad_f(x, theta)
        rg = g_fn(v, theta)
        f0 = f_fn(x, theta)
        restore = state.rmode if opt.restoration else jnp.asarray(False)
        gf_eff = jnp.where(restore, 0.0, 1.0) * gf
        if kkt is not None:
            # Structured (block-banded) path: matrix-free — the dense
            # Jacobian is never formed; J^T lam comes from one VJP.
            _, c_vjp = jax.vjp(lambda xx: c_fn(xx, theta), x)
            Jtlam = c_vjp(lam)[0]
            e_0 = kkt_error_pre(gf, Jtlam, rg, v, lam, zl, zu, 0.0)
            done_now = _stop_rule(e_0, state.be0)
            (dv, dlam, dzl, dzu, gf_dv, dw_used, ok,
             corrector) = compute_step_structured(
                v, lam, zl, zu, mu, dw_last, theta, gf_eff, rg, Jtlam,
                c_vjp, restore)
        else:
            if ev32 and "jac0" not in ablate:
                # f32 assembly for the factorization/GMRES operator;
                # exact f64 J^T lam from one VJP for the KKT error and
                # the step rhs (see IPMOptions.eval_dtype).
                Jc = jac_c(x.astype(jnp.float32),
                           theta.astype(jnp.float32))
                _, c_vjp = jax.vjp(lambda xx: c_fn(xx, theta), x)
                Jtlam = c_vjp(lam)[0]
            elif "jac0" in ablate:
                Jc = jnp.zeros((m, n))
                Jtlam = Jc.T @ lam
            else:
                Jc = jac_c(x, theta)
                Jtlam = Jc.T @ lam
            e_0 = kkt_error_pre(gf, Jtlam, rg, v, lam, zl, zu, 0.0)
            done_now = _stop_rule(e_0, state.be0)
            (dv, dlam, dzl, dzu, gf_dv, dw_used, ok,
             corrector) = compute_step(
                v, lam, zl, zu, mu, dw_last, theta, gf_eff, Jc, rg,
                restore, Jtlam64=Jtlam if ev32 else None)
        # Best-iterate tracking: e_0 is the error of the INCOMING
        # iterate, so record it (and the iterate) before stepping.
        better = e_0 < state.be0
        be0_n = jnp.where(better, e_0, state.be0)
        bv_n = jnp.where(better, v, state.bv)
        blam_n = jnp.where(better, lam, state.blam)
        bzl_n = jnp.where(better, zl, state.bzl)
        bzu_n = jnp.where(better, zu, state.bzu)
        bad = (~ok) | done_now
        # A totally failed factorization (even at delta_w_max) must not
        # contaminate the state: zero the direction (0 * NaN = NaN).
        dv = jnp.where(bad, 0.0, dv)
        dlam = jnp.where(bad, 0.0, dlam)
        dzl = jnp.where(bad, 0.0, dzl)
        dzu = jnp.where(bad, 0.0, dzu)
        gf_dv = jnp.where(bad, 0.0, gf_dv)
        nu_new = update_nu(nu, rg, gf_dv)
        alpha_max = ftb_primal(v, dv, mu)
        alpha_dual = ftb_dual(zl, zu, dzl, dzu, mu)
        # Line-search trial evaluations stay f64 even in ev32 mode:
        # f32-evaluated theta/phi acceptance tests are pure noise near
        # convergence (theta ~ 1e-9 at an f32 noise floor of ~1e-6) and
        # measurably stall the tail (batch convergence 89% with f32
        # trials vs 100% with f64 ones; assembly-only f32 even shortens
        # the max iteration count, 39 -> 29).  g_fn/theta_phi/merit stay
        # dtype-polymorphic for future full-f32 experimentation.
        theta_ev = theta
        if opt.line_search == "filter":
            (dv_eff, dlam_eff, alpha, ls_ok, fth_n, fph_n,
             fcnt_n) = filter_line_search(state, dv, dlam, alpha_max,
                                          gf_dv, corrector, theta_ev,
                                          rg, f0)
        else:
            dv_eff, dlam_eff, alpha, ls_ok = line_search(
                v, dv, dlam, mu, nu_new, alpha_max, gf_dv, corrector,
                theta_ev, rg, f0)
            fth_n, fph_n, fcnt_n = state.fth, state.fph, state.fcnt
        th0 = jnp.sum(jnp.abs(rg))
        if opt.restoration:
            # Restoration acceptance: Armijo decrease on the violation
            # itself (the step is damped Gauss-Newton on theta when
            # ``restore``); overrides the filter result in that mode.
            alphas_r = alpha_max * (0.5 ** jnp.arange(opt.max_ls))
            th_tr = jax.vmap(
                lambda a: jnp.sum(jnp.abs(g_fn(v + a * dv, theta_ev))))(
                    alphas_r)
            ok_r = th_tr <= th0 * (1.0 - opt.eta_armijo * alphas_r)
            any_r = jnp.any(ok_r)
            k_r = jnp.where(any_r, jnp.argmax(ok_r),
                            jnp.argmin(jnp.where(jnp.isnan(th_tr),
                                                 jnp.inf, th_tr)))
            alpha_r = alphas_r[k_r]
            dv_eff = jnp.where(restore, alpha_r * dv, dv_eff)
            # Multipliers freeze during restoration (re-used on exit —
            # the reference stack's IPOPT re-estimates them after its
            # restoration phase returns).
            dlam_eff = jnp.where(restore, 0.0, dlam_eff)
            alpha = jnp.where(restore, alpha_r, alpha)
            ls_ok = jnp.where(restore, any_r, ls_ok)
            fth_n = jnp.where(restore, state.fth, fth_n)
            fph_n = jnp.where(restore, state.fph, fph_n)
            fcnt_n = jnp.where(restore, state.fcnt, fcnt_n)
        fth_n = jnp.where(bad, state.fth, fth_n)
        fph_n = jnp.where(bad, state.fph, fph_n)
        fcnt_n = jnp.where(bad, state.fcnt, fcnt_n)
        dv_eff = jnp.where(bad, 0.0, dv_eff)
        dlam_eff = jnp.where(bad, 0.0, dlam_eff)
        alpha_dual = jnp.where(bad, 0.0, alpha_dual)
        v_n = v + dv_eff
        # Interior repair: fraction-to-boundary keeps (1-tau)*d > 0 in
        # exact arithmetic, but v + dv can round ONTO a bound in f64
        # (catastrophic cancellation when d ~ eps*|v|), after which z/d
        # and the kappa_Sigma clip blow up.  Same role as IPOPT's slack
        # correction (section 3.5).
        margin_l = 1e-14 * jnp.maximum(1.0, jnp.abs(jnp_vl))
        margin_u = 1e-14 * jnp.maximum(1.0, jnp.abs(jnp_vu))
        v_n = jnp.where(jnp_has_l, jnp.maximum(v_n, jnp_vl + margin_l),
                        v_n)
        v_n = jnp.where(jnp_has_u, jnp.minimum(v_n, jnp_vu - margin_u),
                        v_n)
        lam_n = lam + dlam_eff
        zl_n = zl + alpha_dual * dzl
        zu_n = zu + alpha_dual * dzu
        # kappa_Sigma safeguard keeps z consistent with mu/d.  Distances
        # are floored: an iterate can land exactly on a bound in f64
        # despite fraction-to-boundary, and an infinite clip bound would
        # set z = inf.
        dl, du = dists(v_n)
        dl_s = jnp.maximum(dl, 1e-40)
        du_s = jnp.maximum(du, 1e-40)
        zl_n = jnp.where(jnp_has_l,
                         jnp.clip(zl_n, mu / (opt.kappa_sigma * dl_s),
                                  opt.kappa_sigma * mu / dl_s), 0.0)
        zu_n = jnp.where(jnp_has_u,
                         jnp.clip(zu_n, mu / (opt.kappa_sigma * du_s),
                                  opt.kappa_sigma * mu / du_s), 0.0)
        dw_last_n = jnp.where(dw_used > 0.0,
                              jnp.maximum(dw_used, opt.delta_w_min),
                              dw_last)

        if opt.mu_strategy == "adaptive":
            # LOQO-style centrality rule (IPOPT's adaptive mode): mu is a
            # fraction of the average complementarity, with the fraction
            # shrinking when the complementarity pairs are well centered.
            dl_n, du_n = dists(v_n)
            prods_l = jnp.where(jnp_has_l, dl_n * zl_n, jnp.nan)
            prods_u = jnp.where(jnp_has_u, du_n * zu_n, jnp.nan)
            prods = jnp.concatenate([prods_l, prods_u])
            num = jnp.sum(~jnp.isnan(prods))
            avg = jnp.nansum(prods) / jnp.maximum(num, 1)
            min_p = jnp.nanmin(jnp.where(jnp.isnan(prods), jnp.inf, prods))
            xi = min_p / jnp.maximum(avg, 1e-300)
            sigma = 0.1 * jnp.minimum(0.05 * (1.0 - xi)
                                      / jnp.maximum(xi, 1e-8), 2.0) ** 3
            mu_n = jnp.clip(sigma * avg, opt.mu_min, opt.mu_init)
            mu_n = jnp.where(num > 0, mu_n, jnp.maximum(
                opt.tol / 10.0, opt.kappa_mu * mu))
        else:
            e_mu = kkt_error(v_n, lam_n, zl_n, zu_n, mu, theta)
            advance = e_mu <= opt.kappa_eps * mu
            mu_n = jnp.where(
                advance,
                jnp.maximum(opt.tol / 10.0,
                            jnp.minimum(opt.kappa_mu * mu,
                                        mu ** opt.theta_mu)),
                mu)
            mu_n = jnp.maximum(mu_n, opt.mu_min)
        # Filter reset when the barrier parameter moves substantially
        # (stored phi values are mu-dependent; IPOPT re-initialises the
        # filter at every barrier-problem change).
        reset = jnp.abs(jnp.log(jnp.maximum(mu_n, 1e-300))
                        - jnp.log(jnp.maximum(state.mu_f, 1e-300))) \
            > jnp.log(5.0)
        fcnt_n = jnp.where(reset, jnp.asarray(1, fcnt_n.dtype), fcnt_n)
        mu_f_n = jnp.where(reset, mu_n, state.mu_f)
        # Restoration mode transitions: enter after consecutive
        # line-search exhaustions with significant violation (bounded by
        # an entry budget); exit once the violation dropped by
        # kappa_resto (filter restarts — the region changed) OR when
        # restoration itself stalls (theta decreasing below
        # resto_min_decrease relative for resto_stall_patience straight
        # iterations — measured on the space-station NLP: a restoration
        # phase that crawls at 5e-5 relative decrease per iteration
        # never reaches the kappa_resto exit and eats the whole budget).
        if opt.restoration:
            th_new = jnp.sum(jnp.abs(g_fn(v_n, theta)))
            stall = restore \
                & (th_new > (1.0 - opt.resto_min_decrease) * th0)
            r_stall_n = jnp.where(stall, state.r_stall + 1,
                                  jnp.asarray(0, jnp.int32))
            exit_stall = r_stall_n >= opt.resto_stall_patience
            exit_r = (th_new <= jnp.maximum(
                state.th_min, opt.kappa_resto * state.th_enter)) \
                | exit_stall
            ls_fail_n = jnp.where((~restore) & (~ls_ok) & (~bad),
                                  state.ls_fail + 1,
                                  jnp.asarray(0, jnp.int32))
            enter_r = (~restore) & (th0 > state.th_min) & (~bad) \
                & (ls_fail_n >= opt.resto_entry_fails) \
                & (state.r_ent < opt.resto_max_entries)
            r_ent_n = state.r_ent + jnp.asarray(enter_r, jnp.int32)
            rmode_n = jnp.where(restore, ~exit_r, enter_r)
            th_enter_n = jnp.where(enter_r, th0, state.th_enter)
            fcnt_n = jnp.where(restore & exit_r,
                               jnp.asarray(1, fcnt_n.dtype), fcnt_n)
            # The restoration phase runs its own barrier (IPOPT starts a
            # fresh mu for the restoration NLP): a mu ground down by the
            # failed main phase walls the iterate in with huge Sigma and
            # the feasibility steps vanish.  Bump on entry, hold while
            # restoring.
            mu_n = jnp.where(enter_r,
                             jnp.maximum(mu, 0.1 * opt.mu_init),
                             jnp.where(restore & ~exit_r, mu, mu_n))
        else:
            rmode_n = state.rmode
            th_enter_n = state.th_enter
            ls_fail_n = state.ls_fail
            r_stall_n = state.r_stall
            r_ent_n = state.r_ent
        return _State(v_n, lam_n, zl_n, zu_n, mu_n, nu_new, dw_used,
                      dw_last_n, it + 1, e_0, done_now,
                      fth_n, fph_n, fcnt_n, state.th_min, state.th_max,
                      mu_f_n, rmode_n, th_enter_n,
                      ls_fail_n, r_stall_n, r_ent_n,
                      be0_n, bv_n, blam_n, bzl_n, bzu_n)

    def init_state(x0, theta, lam0=None, zl0=None, zu0=None, mu0=None):
        """Initial IPM state; optionally warm-started with multipliers.

        Warm-start inputs (``lam0`` (m,), ``zl0``/``zu0`` (n,) for the
        original variables, ``mu0`` scalar) are what the mesh-refinement
        loop carries between iterations — the on-device equivalent of
        the reference's IPOPT ``warm_start_init_point``
        (``pycollo/backend.py:1703-1709``).
        """
        x0 = jnp.asarray(x0, dtype=jnp_vl.dtype)
        xl_j = jnp.asarray(xl)
        xu_j = jnp.asarray(xu)
        x_init = _interior_init(x0, xl_j, xu_j, opt.kappa_1, opt.kappa_2)
        if ns:
            c0 = c_fn(x_init, theta)
            s_init = _interior_init(c0[ineq_idx], jnp.asarray(cl[ineq_idx]),
                                    jnp.asarray(cu[ineq_idx]),
                                    opt.kappa_1, opt.kappa_2)
            v0 = jnp.concatenate([x_init, s_init])
        else:
            v0 = x_init
        mu0 = jnp.asarray(opt.mu_init if mu0 is None else mu0,
                          dtype=v0.dtype)
        dl0, du0 = dists(v0)
        zl_def = jnp.where(jnp_has_l, mu0 / dl0, 0.0)
        zu_def = jnp.where(jnp_has_u, mu0 / du0, 0.0)
        if zl0 is not None:
            zl_x = jnp.clip(jnp.asarray(zl0), 1e-6, 1e6)
            zl_init = jnp.where(jnp_has_l,
                                jnp.concatenate([zl_x, zl_def[n:]])
                                if ns else zl_x, 0.0)
        else:
            zl_init = zl_def
        if zu0 is not None:
            zu_x = jnp.clip(jnp.asarray(zu0), 1e-6, 1e6)
            zu_init = jnp.where(jnp_has_u,
                                jnp.concatenate([zu_x, zu_def[n:]])
                                if ns else zu_x, 0.0)
        else:
            zu_init = zu_def
        lam_init = jnp.zeros(m) if lam0 is None else jnp.asarray(lam0)
        # Filter initialisation (IPOPT sec. 3.7): a single guard entry
        # blocking any point with violation >= theta_max.
        th0 = jnp.sum(jnp.abs(g_fn(v0, theta)))
        th_ref = jnp.maximum(1.0, th0)
        th_min = 1e-4 * th_ref
        th_max = 1e4 * th_ref
        fth0 = jnp.full((FSZ,), jnp.inf).at[0].set(th_max)
        fph0 = jnp.full((FSZ,), jnp.inf).at[0].set(-jnp.inf)
        return _State(v0, lam_init, zl_init, zu_init, mu0,
                      jnp.asarray(1.0, v0.dtype),
                      jnp.asarray(opt.delta_w_init, v0.dtype),
                      jnp.asarray(opt.delta_w_first, v0.dtype),
                      jnp.asarray(0, jnp.int32),
                      jnp.asarray(jnp.inf, v0.dtype),
                      jnp.asarray(False),
                      fth0, fph0, jnp.asarray(1, jnp.int32),
                      th_min, th_max, mu0,
                      jnp.asarray(False), jnp.asarray(0.0, v0.dtype),
                      jnp.asarray(0, jnp.int32),
                      jnp.asarray(0, jnp.int32),
                      jnp.asarray(0, jnp.int32),
                      jnp.asarray(jnp.inf, v0.dtype),
                      v0, lam_init, zl_init, zu_init)

    def _run(state0, theta):
        def cond(state):
            return (~state.done) & (state.it < opt.max_iter)

        final = jax.lax.while_loop(cond, lambda s: body(s, theta), state0)
        # Return the best-KKT iterate seen, not the last, when a near-
        # solution iterate was reached: a late noise-amplified step can
        # destroy a near-converged iterate (see the _State.be0 note).
        # Outside that regime (be0 still large — e.g. locally infeasible
        # problems) the LAST iterate is the meaningful output: the
        # restoration phase's minimal-violation point, not whichever
        # early iterate happened to have the smallest scaled KKT error.
        use_best = final.be0 <= jnp.maximum(opt.tol, 1e-4)
        v_out = jnp.where(use_best, final.bv, final.v)
        lam_out = jnp.where(use_best, final.blam, final.lam)
        zl_out = jnp.where(use_best, final.bzl, final.zl)
        zu_out = jnp.where(use_best, final.bzu, final.zu)
        e_out = jnp.where(use_best, final.be0, final.e0)
        conv_out = final.be0 <= opt.tol
        if ev32:
            # The running error read the f32-rounded Jacobian; certify
            # the returned iterate with one fresh full-f64 evaluation.
            e_out = kkt_error(v_out, lam_out, zl_out, zu_out, 0.0,
                              theta)
            conv_out = e_out <= opt.tol
        x = v_out[:n]
        slack = v_out[n:]
        return IPMResult(x=x, slack=slack, lam=lam_out,
                         zl=zl_out, zu=zu_out,
                         f=f_fn(x, theta), kkt_error=e_out,
                         mu=final.mu, iterations=final.it,
                         converged=conv_out)

    @_highest_precision
    def solve(x0, theta):
        return _run(init_state(x0, theta), theta)

    @_highest_precision
    def solve_warm(x0, theta, lam0, zl0, zu0, mu0):
        return _run(init_state(x0, theta, lam0, zl0, zu0, mu0), theta)

    solve.warm = solve_warm

    @_highest_precision
    def debug_step(state: _State, theta):
        """One body step with diagnostics (host-side debugging only)."""
        v, lam, zl, zu, mu, nu = (state.v, state.lam, state.zl, state.zu,
                                  state.mu, state.nu)
        dw_last = state.dw_last
        x = v[:n]
        gf = grad_f(x, theta)
        Jc = jac_c(x, theta)
        rg = g_fn(v, theta)
        f0 = f_fn(x, theta)
        dv, dlam, dzl, dzu, gf_dv, dw_used, ok, corrector = compute_step(
            v, lam, zl, zu, mu, dw_last, theta, gf, Jc, rg)
        nu_new = update_nu(nu, rg, gf_dv)
        alpha_max = ftb_primal(v, dv, mu)
        alpha_dual = ftb_dual(zl, zu, dzl, dzu, mu)
        if opt.line_search == "filter":
            _, _, alpha, ls_ok, _, _, _ = filter_line_search(
                state, dv, dlam, alpha_max, gf_dv, corrector, theta, rg,
                f0)
        else:
            _, _, alpha, ls_ok = line_search(
                v, dv, dlam, mu, nu_new, alpha_max, gf_dv, corrector,
                theta, rg, f0)
        rd = jnp.concatenate([gf + Jc.T @ lam,
                              -lam[ineq_idx] if ns else jnp.zeros(0)]) \
            - zl + zu
        dl, du = dists(v)
        return dict(alpha=float(alpha), alpha_max=float(alpha_max),
                    alpha_dual=float(alpha_dual), ls_ok=bool(ls_ok),
                    ok=bool(ok), dw_used=float(dw_used),
                    gf_dv=float(gf_dv),
                    g_inf=float(jnp.max(jnp.abs(g_fn(v, theta)))) if m
                    else 0.0,
                    rd_inf=float(jnp.max(jnp.abs(rd))),
                    compl_inf=float(jnp.max(jnp.abs(jnp.where(
                        jnp_has_l, dl * zl - mu, 0.0)))),
                    dv_inf=float(jnp.max(jnp.abs(dv))),
                    merit=float(merit(v, mu, nu_new, theta)))

    solve.dims = dict(n=n, m=m, ns=ns, nv=nv)
    solve.ineq_idx = ineq_idx
    solve._debug_step = debug_step
    # Debug / introspection hooks (used by tests and the tuning harness).
    solve._body = body
    solve._init_state = init_state
    solve._compute_step = compute_step
    solve._compute_step_structured = compute_step_structured \
        if kkt is not None else None
    solve._kkt_error = kkt_error
    solve._merit = merit
    solve._g = g_fn
    return solve
