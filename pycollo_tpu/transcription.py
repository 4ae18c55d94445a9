"""Transcription: OCP -> scaled NLP with JAX residual evaluators.

This module replaces the reference's per-iteration CasADi symbol expansion
(``pycollo/backend.py:1403-1679``) and the iteration bookkeeping
(``pycollo/iteration.py:196-453``) with a dense, batched JAX evaluation:
the state/control trajectories of each phase are matrices ``(ny, N)`` /
``(nu, N)``, per-node user functions are ``vmap``-ed across all mesh nodes
at once, and the defect/integral operators are plain matmuls with the static
mesh tables (no per-node symbolic expansion).

Layout invariants match the reference (SURVEY.md section 3.5):

* NLP variables per phase: ``[y0(N), y1(N), ..., u0(N), ..., q, t0, tF]``,
  phases concatenated, then global ``s`` (``pycollo/iteration.py:208-262``).
* Constraints per phase: ``[defects (ny x num_defect), paths (npc x N),
  integrals (nq)]`` then global endpoint constraints
  (``pycollo/iteration.py:264-314``).
* Defect (integral form): ``zeta = E y + 0.5 (tF - t0) I f`` with the
  [+1, -1] difference pattern in ``E`` (``pycollo/backend.py:1601-1603``).
* Integral: ``rho = q - 0.5 (tF - t0) W g`` (``pycollo/backend.py:1645-1647``).
* Time affinely normalized to tau in [-1, 1].
* Variables with equal lower == upper bounds leave the NLP and become
  entries of the per-instance parameter vector ``theta``
  (``pycollo/bounds.py:901-935``) — which is also how batched MPC-style
  instance perturbation enters.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import mesh as mesh_mod
from .bounds import (ProcessedPhaseBounds, ProcessedProblemBounds,
                     process_phase_bounds, process_problem_bounds)
from .guess import ProcessedPhaseGuess, process_phase_guess
from .structures import Endpoints, PhaseEndpoints


class FunctionalProgram:
    """Adapter for the functional (JAX-callable) frontend."""

    def __init__(self, ocp):
        import jax.numpy as jnp
        self._jnp = jnp
        self.ocp = ocp
        self.phase_functions = [_FunctionalPhase(p, jnp) for p in ocp.phases]
        if not callable(ocp.objective_function):
            raise TypeError(
                "With the functional frontend, ocp.objective_function must "
                "be a callable taking an Endpoints structure.")
        self._objective = ocp.objective_function
        self._endpoint = ocp.endpoint_constraints \
            if callable(ocp.endpoint_constraints) else None

    def objective(self, ep: Endpoints):
        return self._objective(ep)

    def endpoint_constraints(self, ep: Endpoints):
        if self._endpoint is None:
            dt = ep.phase[0].y0.dtype if ep.phase else None
            return self._jnp.zeros(0, dt)
        return self._jnp.atleast_1d(self._endpoint(ep))

    def resolve_numeric(self, value):
        return value

    def phase_resolver(self, phase_index):
        return lambda value: value


class _FunctionalPhase:
    def __init__(self, phase, jnp):
        self._jnp = jnp
        self.phase = phase
        self._dyn = phase.state_equations
        if not callable(self._dyn):
            raise TypeError(
                f"Phase {phase.name!r}: with the functional frontend, "
                f"state_equations must be a callable f(y, u, t, s).")
        self._path = phase.path_constraints \
            if callable(phase.path_constraints) else None
        self._integrand = phase.integrand_functions \
            if callable(phase.integrand_functions) else None

    def dynamics(self, y, u, t, s):
        return self._jnp.atleast_1d(self._dyn(y, u, t, s))

    def path(self, y, u, t, s):
        if self._path is None:
            return self._jnp.zeros(0, y.dtype)
        return self._jnp.atleast_1d(self._path(y, u, t, s))

    def integrand(self, y, u, t, s):
        if self._integrand is None:
            return self._jnp.zeros(0, y.dtype)
        return self._jnp.atleast_1d(self._integrand(y, u, t, s))


@dataclass
class PhaseLayout:
    """Index bookkeeping for one phase within the flat NLP vectors.

    Parity with ``pycollo/iteration.py:196-342`` (variable/constraint
    counts and slices).
    """

    ny: int
    nu: int
    nq: int
    npc: int
    N: int
    num_defect: int
    y_off: int
    u_off: int
    q_off: int
    t_off: int
    c_defect_off: int
    c_path_off: int
    c_integral_off: int
    defect_states: np.ndarray      # indices of states with defect rows

    @property
    def num_defect_rows(self) -> int:
        return len(self.defect_states) * self.num_defect

    @property
    def y_slice(self):
        return slice(self.y_off, self.y_off + self.ny * self.N)

    @property
    def u_slice(self):
        return slice(self.u_off, self.u_off + self.nu * self.N)

    @property
    def q_slice(self):
        return slice(self.q_off, self.q_off + self.nq)

    @property
    def t_slice(self):
        return slice(self.t_off, self.t_off + 2)


@dataclass
class Layout:
    phases: List[PhaseLayout]
    s_off: int
    ns: int
    n_full: int
    c_endpoint_off: int
    nb: int
    m_total: int

    @property
    def s_slice(self):
        return slice(self.s_off, self.s_off + self.ns)


def build_layout(phase_dims, tables, ns: int, nb: int,
                 defect_state_lists) -> Layout:
    phases = []
    off = 0
    c_off = 0
    for (ny, nu, nq, npc), t, dstates in zip(phase_dims, tables,
                                             defect_state_lists):
        N = t.N
        pl = PhaseLayout(ny=ny, nu=nu, nq=nq, npc=npc, N=N,
                         num_defect=t.num_defect,
                         y_off=off, u_off=off + ny * N,
                         q_off=off + (ny + nu) * N,
                         t_off=off + (ny + nu) * N + nq,
                         c_defect_off=c_off,
                         c_path_off=c_off + len(dstates) * t.num_defect,
                         c_integral_off=c_off + len(dstates) * t.num_defect
                         + npc * N,
                         defect_states=np.asarray(dstates, dtype=int))
        off += (ny + nu) * N + nq + 2
        c_off = pl.c_integral_off + nq
        phases.append(pl)
    return Layout(phases=phases, s_off=off, ns=ns, n_full=off + ns,
                  c_endpoint_off=c_off, nb=nb, m_total=c_off + nb)


class CompiledOCP:
    """The compiled problem: frontend program + bounds/guess + iterations.

    Plays the role of the reference ``Backend``
    (``pycollo/backend.py:71-160``): owns the processed problem data and
    creates :class:`MeshIteration` objects as the refinement loop proceeds.
    """

    def __init__(self, ocp):
        import jax
        self.ocp = ocp
        self.settings = ocp.settings
        if self.settings.dtype == "float64":
            jax.config.update("jax_enable_x64", True)

        if ocp.is_symbolic:
            from .sym_backend import SymbolicProgram
            self.program = SymbolicProgram(ocp)
        else:
            self.program = FunctionalProgram(ocp)

        # Bounds (with symbolic resolution through aux data).
        self.phase_bounds: List[ProcessedPhaseBounds] = []
        for i, phase in enumerate(ocp.phases):
            resolver = self.program.phase_resolver(i) \
                if hasattr(self.program, "phase_resolver") else (lambda v: v)
            self.phase_bounds.append(
                process_phase_bounds(phase, self.settings, resolver))
        self.problem_bounds: ProcessedProblemBounds = process_problem_bounds(
            ocp, self.settings, self.program.resolve_numeric)

        # Guesses.
        self.phase_guesses: List[ProcessedPhaseGuess] = [
            process_phase_guess(p, self.program.resolve_numeric)
            for p in ocp.phases]
        s_guess = self.program.resolve_numeric(
            ocp.guess.parameter_variables)
        ns = ocp.number_parameter_variables
        if s_guess is None:
            sb = self.problem_bounds.s_bnd
            finite = np.isfinite(sb).all(axis=1) & (np.abs(sb) < 1e18).all(axis=1)
            s_guess = np.where(finite, 0.5 * (sb[:, 0] + sb[:, 1]), 0.0)
        self.s_guess = np.atleast_1d(np.asarray(s_guess, dtype=float)) \
            if ns else np.zeros(0)
        if self.s_guess.shape != (ns,):
            raise ValueError(f"Parameter guess must have shape ({ns},).")

        self.mesh_iterations: List["MeshIteration"] = []
        self.create_initial_iteration()

    # ------------------------------------------------------------------
    def initial_mesh_tables(self):
        method = self.settings.quadrature_method
        tables = []
        for phase in self.ocp.phases:
            pm = phase.mesh
            tables.append(mesh_mod.build_phase_tables(
                method, pm.mesh_section_sizes,
                pm.number_mesh_section_nodes))
        return tables

    def create_initial_iteration(self):
        tables = self.initial_mesh_tables()
        it = MeshIteration(self, tables, self.phase_guesses, self.s_guess,
                           number=1)
        self.mesh_iterations.append(it)
        return it

    def new_mesh_iteration(self, tables, phase_guesses, s_guess):
        """Start the next mesh iteration (``pycollo/backend.py:827-851``)."""
        it = MeshIteration(self, tables, phase_guesses, s_guess,
                           number=len(self.mesh_iterations) + 1)
        self.mesh_iterations.append(it)
        return it


class MeshIteration:
    """One transcription + solve on a fixed mesh.

    Parity with ``pycollo/iteration.py`` (live code path): interpolate the
    guess onto the mesh, build scaling, build the scaled NLP, solve, and
    post-process.  All heavy computation is jitted JAX; this class holds
    the static numpy metadata.
    """

    def __init__(self, compiled: CompiledOCP, tables, phase_guesses,
                 s_guess, number: int):
        import jax
        import jax.numpy as jnp
        self._jax = jax
        self._jnp = jnp
        self.compiled = compiled
        self.ocp = compiled.ocp
        self.settings = compiled.settings
        self.tables = tables
        self.number = number
        self.phase_guesses = phase_guesses
        self.s_guess = np.asarray(s_guess, dtype=float)

        ocp = self.ocp
        self.ns = ocp.number_parameter_variables
        self.nb = ocp.number_endpoint_constraints

        phase_dims = []
        defect_state_lists = []
        for phase, pb in zip(ocp.phases, compiled.phase_bounds):
            ny = phase.number_state_variables
            nu = phase.number_control_variables
            nq = phase.number_integrand_functions
            npc = phase.number_path_constraints
            phase_dims.append((ny, nu, nq, npc))
            if self.settings.remove_constant_variables:
                defect_state_lists.append(np.nonzero(pb.y_needed)[0])
            else:
                defect_state_lists.append(np.arange(ny))
        self.layout = build_layout(phase_dims, tables, self.ns, self.nb,
                                   defect_state_lists)

        from .profiling import Profiler
        self.profiler = Profiler()
        with self.profiler.span("variable metadata"):
            self._build_variable_metadata()
        with self.profiler.span("constraint metadata"):
            self._build_constraint_metadata()
        with self.profiler.span("guess interpolation"):
            self._build_guess_vector()
        with self.profiler.span("NLP function build"):
            self._build_nlp_functions()
        with self.profiler.span("scaling"):
            self._build_scaling()
        self._solver = None
        self._solve_fn = None
        if self.settings.check_nlp_functions:
            self.dump_nlp_check_values()

    # -- variable metadata ---------------------------------------------
    def _ocp_var_scales_from_bounds(self):
        """Per-OCP-variable scales from bounds: V = xu - xl, r = midpoint
        (``pycollo/scaling.py:87-92``), V=1/r=0 for un/half-bounded.

        Returns flat arrays over the OCP variable order (per phase
        [y..., u..., q..., t0, tF], then s) — the granularity the EWMA
        cross-iteration update averages at
        (``pycollo/scaling.py:283-344``)."""
        inf_thresh = 1e18

        def var_scale(bnd):
            lo, hi = bnd[..., 0], bnd[..., 1]
            finite = (np.abs(lo) < inf_thresh) & (np.abs(hi) < inf_thresh) \
                & (hi > lo)
            Vv = np.where(finite, hi - lo, 1.0)
            rv = np.where(finite, 0.5 * (lo + hi), 0.0)
            return Vv, rv

        V_parts, r_parts = [], []
        for pb in self.compiled.phase_bounds:
            for bnd in (pb.y_bnd, pb.u_bnd, pb.q_bnd,
                        np.stack([pb.t0_bnd, pb.tF_bnd])):
                Vv, rv = var_scale(np.atleast_2d(bnd))
                V_parts.append(Vv)
                r_parts.append(rv)
        Vs, rs = var_scale(self.compiled.problem_bounds.s_bnd)
        V_parts.append(Vs)
        r_parts.append(rs)
        return (np.concatenate(V_parts) if V_parts else np.zeros(0),
                np.concatenate(r_parts) if r_parts else np.zeros(0))

    def _ocp_var_scales_from_guess(self, V_last, r_last):
        """Per-OCP-variable scales from the incoming guess trajectories
        (``pycollo/scaling.py:295-324``): trajectory variables (y, u) get
        V = amplitude across mesh nodes, r = midpoint of the range;
        point variables (q, t, s) get V = |value|,
        r = (V_next / V_last) * r_last.  Degenerate (zero) amplitudes
        keep the previous scale (guard absent in the reference, which
        divides by zero there)."""
        V = np.array(V_last)
        r = np.array(r_last)
        off = 0
        for pl, g in zip(self.layout.phases, self.phase_guesses):
            for traj in (g.y, g.u):
                for row in traj:
                    amp = row.max() - row.min()
                    if amp > 1e-12:
                        V[off] = amp
                        r[off] = row.max() - 0.5 * amp
                    off += 1
            for val in list(np.atleast_1d(g.q)) + [g.t0, g.tF]:
                v_next = abs(float(val))
                if v_next > 1e-12:
                    r[off] = (v_next / V[off]) * r[off]
                    V[off] = v_next
                off += 1
        for val in self.s_guess:
            v_next = abs(float(val))
            if v_next > 1e-12:
                r[off] = (v_next / V[off]) * r[off]
                V[off] = v_next
            off += 1
        return V, r

    def _ewma_weights(self, length: int):
        """Exponential weights over [oldest, ..., newest] mirroring
        ``pycollo/scaling.py:287-293``: newest gets alpha, older entries
        alpha*(1-alpha)^age, and the oldest entry's weight is divided by
        alpha so the weights sum to one."""
        alpha = self.settings.scaling_weight
        w = np.array([alpha * (1 - alpha) ** i for i in range(length)])
        w = np.flip(w)
        w[0] /= alpha
        return w

    def _build_variable_metadata(self):
        lay = self.layout
        cb = self.compiled
        inf_thresh = 1e18
        lb = np.empty(lay.n_full)
        ub = np.empty(lay.n_full)

        V_ocp, r_ocp = self._ocp_var_scales_from_bounds()
        use_update = (self.settings.update_scaling and self.number > 1
                      and self.settings.scaling_method != "none")
        if use_update:
            prev = self.compiled.mesh_iterations
            V_next, r_next = self._ocp_var_scales_from_guess(
                prev[-1].V_ocp, prev[-1].r_ocp)
            weights = self._ewma_weights(len(prev) + 1)
            V_ocp = np.average(
                np.vstack([[p.V_ocp for p in prev], V_next[None]]),
                axis=0, weights=weights)
            r_ocp = np.average(
                np.vstack([[p.r_ocp for p in prev], r_next[None]]),
                axis=0, weights=weights)
        self.V_ocp = V_ocp
        self.r_ocp = r_ocp

        # Expand OCP-level scales to the mesh and fill per-node bounds.
        V = np.ones(lay.n_full)
        r = np.zeros(lay.n_full)
        off = 0
        for pl, pb, t in zip(lay.phases, cb.phase_bounds, self.tables):
            N = pl.N
            # y: per-node bounds with endpoint overrides
            # (``pycollo/iteration.py:408-429``).
            y_lb = np.tile(pb.y_bnd[:, 0:1], (1, N))
            y_ub = np.tile(pb.y_bnd[:, 1:2], (1, N))
            y_lb[:, 0] = pb.y_t0_bnd[:, 0]
            y_ub[:, 0] = pb.y_t0_bnd[:, 1]
            y_lb[:, -1] = pb.y_tF_bnd[:, 0]
            y_ub[:, -1] = pb.y_tF_bnd[:, 1]
            lb[pl.y_slice] = y_lb.ravel()
            ub[pl.y_slice] = y_ub.ravel()
            V[pl.y_slice] = np.repeat(V_ocp[off:off + pl.ny], N)
            r[pl.y_slice] = np.repeat(r_ocp[off:off + pl.ny], N)
            off += pl.ny

            lb[pl.u_slice] = np.repeat(pb.u_bnd[:, 0], N)
            ub[pl.u_slice] = np.repeat(pb.u_bnd[:, 1], N)
            V[pl.u_slice] = np.repeat(V_ocp[off:off + pl.nu], N)
            r[pl.u_slice] = np.repeat(r_ocp[off:off + pl.nu], N)
            off += pl.nu

            lb[pl.q_slice] = pb.q_bnd[:, 0]
            ub[pl.q_slice] = pb.q_bnd[:, 1]
            V[pl.q_slice] = V_ocp[off:off + pl.nq]
            r[pl.q_slice] = r_ocp[off:off + pl.nq]
            off += pl.nq

            t_bnd = np.stack([pb.t0_bnd, pb.tF_bnd])
            lb[pl.t_slice] = t_bnd[:, 0]
            ub[pl.t_slice] = t_bnd[:, 1]
            V[pl.t_slice] = V_ocp[off:off + 2]
            r[pl.t_slice] = r_ocp[off:off + 2]
            off += 2

        sb = cb.problem_bounds.s_bnd
        lb[lay.s_slice] = sb[:, 0]
        ub[lay.s_slice] = sb[:, 1]
        V[lay.s_slice] = V_ocp[off:off + lay.ns]
        r[lay.s_slice] = r_ocp[off:off + lay.ns]

        if self.settings.scaling_method == "none":
            V = np.ones_like(V)
            r = np.zeros_like(r)

        self.lb_full = lb
        self.ub_full = ub
        self.V_full = V
        self.r_full = r
        self.free_mask = (ub - lb) > 0
        self.free_idx = np.nonzero(self.free_mask)[0]
        self.fixed_idx = np.nonzero(~self.free_mask)[0]
        self.n_free = len(self.free_idx)
        # Default theta: fixed entries hold their pinned value.
        theta = np.zeros(lay.n_full)
        theta[self.fixed_idx] = 0.5 * (lb[self.fixed_idx]
                                       + ub[self.fixed_idx])
        self.theta_default = theta
        # Scaled bounds for the free variables.
        Vf = V[self.free_idx]
        rf = r[self.free_idx]
        with np.errstate(over="ignore", invalid="ignore"):
            self.xs_lb = np.where(lb[self.free_idx] < -inf_thresh, -1e19,
                                  (lb[self.free_idx] - rf) / Vf)
            self.xs_ub = np.where(ub[self.free_idx] > inf_thresh, 1e19,
                                  (ub[self.free_idx] - rf) / Vf)

    # -- constraint metadata --------------------------------------------
    def _build_constraint_metadata(self):
        lay = self.layout
        cb = self.compiled
        cl = np.empty(lay.m_total)
        cu = np.empty(lay.m_total)
        for pl, pb in zip(lay.phases, cb.phase_bounds):
            d0 = pl.c_defect_off
            cl[d0:pl.c_path_off] = 0.0
            cu[d0:pl.c_path_off] = 0.0
            path_lb = np.repeat(pb.path_bnd[:, 0], pl.N)
            path_ub = np.repeat(pb.path_bnd[:, 1], pl.N)
            cl[pl.c_path_off:pl.c_integral_off] = path_lb
            cu[pl.c_path_off:pl.c_integral_off] = path_ub
            cl[pl.c_integral_off:pl.c_integral_off + pl.nq] = 0.0
            cu[pl.c_integral_off:pl.c_integral_off + pl.nq] = 0.0
        bb = cb.problem_bounds.b_bnd
        cl[lay.c_endpoint_off:] = bb[:, 0]
        cu[lay.c_endpoint_off:] = bb[:, 1]
        self.cl = cl
        self.cu = cu

    # -- guess -----------------------------------------------------------
    def _build_guess_vector(self):
        lay = self.layout
        x = np.array(self.theta_default)
        for pl, g, t in zip(lay.phases, self.phase_guesses, self.tables):
            y_mesh, u_mesh = g.interpolate(t.tau)
            x[pl.y_slice] = y_mesh.ravel()
            x[pl.u_slice] = u_mesh.ravel()
            x[pl.q_slice] = g.q
            x[pl.t_off] = g.t0
            x[pl.t_off + 1] = g.tF
        x[lay.s_slice] = self.s_guess
        self.x_full_guess = x
        # Fixed entries of theta keep their pinned (bound) values; the
        # guess supplies the free entries.
        self.xs_guess = ((x - self.r_full) / self.V_full)[self.free_idx]

    # -- NLP functions ----------------------------------------------------
    def _build_nlp_functions(self):
        import jax
        import jax.numpy as jnp
        lay = self.layout
        program = self.compiled.program
        tables = self.tables
        free_idx = jnp.asarray(self.free_idx)
        V_free = jnp.asarray(self.V_full[self.free_idx])
        r_free = jnp.asarray(self.r_full[self.free_idx])
        jtables = [dict(E=jnp.asarray(t.E), I=jnp.asarray(t.I),
                        W=jnp.asarray(t.W), tau=jnp.asarray(t.tau))
                   for t in tables]

        def assemble_full(xs, theta):
            # theta's dtype governs the evaluation precision (the solver
            # passes an f32 theta for trial/derivative evaluations in
            # ``eval_dtype="f32"`` mode); captured f64 constants are cast
            # to it at trace time (constant-folded by XLA).
            dt = theta.dtype
            return theta.at[free_idx].set(
                xs.astype(dt) * V_free.astype(dt) + r_free.astype(dt))

        def phase_values(x_full, pl, jt, s):
            y = x_full[pl.y_slice].reshape(pl.ny, pl.N)
            u = x_full[pl.u_slice].reshape(pl.nu, pl.N)
            q = x_full[pl.q_slice]
            t0 = x_full[pl.t_off]
            tF = x_full[pl.t_off + 1]
            stretch = 0.5 * (tF - t0)
            shift = 0.5 * (t0 + tF)
            t_nodes = stretch * jt["tau"].astype(x_full.dtype) + shift
            return y, u, q, t0, tF, stretch, t_nodes

        def endpoints(x_full):
            s = x_full[lay.s_slice]
            eps = []
            for pl, jt in zip(lay.phases, jtables):
                y, u, q, t0, tF, _, _ = phase_values(x_full, pl, jt, s)
                eps.append(PhaseEndpoints(y0=y[:, 0], yF=y[:, -1], q=q,
                                          t0=t0, tF=tF))
            return Endpoints(phase=tuple(eps), s=s)

        def constraints_raw(x_full):
            """Unscaled constraint vector in the reference layout."""
            s = x_full[lay.s_slice]
            parts = []
            for i, (pl, jt) in enumerate(zip(lay.phases, jtables)):
                pf = program.phase_functions[i]
                y, u, q, t0, tF, stretch, t_nodes = phase_values(
                    x_full, pl, jt, s)
                yT = y.T          # (N, ny)
                uT = u.T          # (N, nu)
                f = jax.vmap(pf.dynamics, in_axes=(0, 0, 0, None))(
                    yT, uT, t_nodes, s)          # (N, ny)
                dt = x_full.dtype
                defect = jt["E"].astype(dt) @ yT \
                    + stretch * (jt["I"].astype(dt) @ f)
                defect = defect[:, pl.defect_states]
                parts.append(defect.T.reshape(-1))
                if pl.npc:
                    pc = jax.vmap(pf.path, in_axes=(0, 0, 0, None))(
                        yT, uT, t_nodes, s)      # (N, npc)
                    parts.append(pc.T.reshape(-1))
                if pl.nq:
                    rho = jax.vmap(pf.integrand, in_axes=(0, 0, 0, None))(
                        yT, uT, t_nodes, s)      # (N, nq)
                    parts.append(
                        q - stretch * (jt["W"].astype(x_full.dtype) @ rho))
            ep = endpoints(x_full)
            b = program.endpoint_constraints(ep)
            parts.append(b.reshape(-1))
            return jnp.concatenate(parts) if parts else \
                jnp.zeros(0, x_full.dtype)

        def objective_raw(x_full):
            return jnp.squeeze(program.objective(endpoints(x_full)))

        def f_unscaled(xs, theta):
            return objective_raw(assemble_full(xs, theta))

        def c_unscaled(xs, theta):
            return constraints_raw(assemble_full(xs, theta))

        self.assemble_full = assemble_full
        self.endpoints_of = endpoints
        self.f_unscaled = f_unscaled
        self.c_unscaled = c_unscaled
        self._constraints_raw = constraints_raw
        self._objective_raw = objective_raw
        self._jtables = jtables

    # -- structured derivatives -------------------------------------------
    def _build_structured_derivatives(self):
        """Per-node block assembly of the constraint Jacobian and the
        Lagrangian Hessian.

        On-device replacement for the reference's sparse symbolic AD
        (hSAD ``expression_graph.py`` / the block-structured assembly in
        ``compiled.py:213-539``): the only nonlinearities are the
        *per-node* user functions, so their small Jacobian/Hessian blocks
        are computed with a single ``vmap`` over all mesh nodes and
        scattered into the transcription operators' structural pattern.
        Cost is O(node_dim x node_eval x N) instead of O(n x full_eval) —
        the difference between one batched pass and hundreds of
        whole-program AD sweeps.
        """
        if getattr(self, "_structured_derivs", None) is not None:
            return self._structured_derivs
        import jax
        import jax.numpy as jnp
        lay = self.layout
        program = self.compiled.program
        jtables = self._jtables
        free_idx = jnp.asarray(self.free_idx)
        V_free = jnp.asarray(self.V_full[self.free_idx])
        n_full = lay.n_full
        m_total = lay.m_total

        # Static per-phase index arrays.
        phase_static = []
        ep_idx_list = []
        for pl, t in zip(lay.phases, self.tables):
            nz = pl.ny + pl.nu
            node_cols = np.empty((pl.N, nz), dtype=np.int64)
            for l in range(pl.ny):
                node_cols[:, l] = pl.y_off + l * pl.N + np.arange(pl.N)
            for l in range(pl.nu):
                node_cols[:, pl.ny + l] = pl.u_off + l * pl.N \
                    + np.arange(pl.N)
            # Hessian node block covers [z..., t0, tF, s...].
            D = nz + 2 + lay.ns
            hess_idx = np.empty((pl.N, D), dtype=np.int64)
            hess_idx[:, :nz] = node_cols
            hess_idx[:, nz] = pl.t_off
            hess_idx[:, nz + 1] = pl.t_off + 1
            hess_idx[:, nz + 2:] = lay.s_off + np.arange(lay.ns)[None, :]
            phase_static.append(dict(node_cols=jnp.asarray(node_cols),
                                     hess_idx=jnp.asarray(hess_idx),
                                     nz=nz, D=D))
            ep_idx_list.extend(
                [pl.y_off + l * pl.N for l in range(pl.ny)]
                + [pl.y_off + (l + 1) * pl.N - 1 for l in range(pl.ny)]
                + list(range(pl.q_off, pl.q_off + pl.nq))
                + [pl.t_off, pl.t_off + 1])
        ep_idx_list.extend(range(lay.s_off, lay.s_off + lay.ns))
        ep_idx = jnp.asarray(np.asarray(ep_idx_list, dtype=np.int64))

        def phase_F(i, pl, jt):
            """Per-node concatenated user function (f, path, rho)."""
            pf = program.phase_functions[i]
            tau = jt["tau"]

            def F(wz, t0, tF, s, tau_j):
                y = wz[:pl.ny]
                u = wz[pl.ny:]
                t_j = 0.5 * (tF - t0) * tau_j + 0.5 * (t0 + tF)
                parts = [pf.dynamics(y, u, t_j, s)]
                if pl.npc:
                    parts.append(pf.path(y, u, t_j, s))
                if pl.nq:
                    parts.append(pf.integrand(y, u, t_j, s))
                return jnp.concatenate(parts)

            return F

        def jac_full(x_full):
            """Dense (m_total, n_full) Jacobian of the raw constraints.

            Dtype-polymorphic: follows ``x_full.dtype`` (the solver's
            ``eval_dtype="f32"`` mode assembles in f32)."""
            s = x_full[lay.s_slice]
            dt = x_full.dtype
            J = jnp.zeros((m_total, n_full), dt)
            for i, (pl, jt, st) in enumerate(zip(lay.phases, jtables,
                                                 phase_static)):
                t0 = x_full[pl.t_off]
                tF = x_full[pl.t_off + 1]
                stretch = 0.5 * (tF - t0)
                y = x_full[pl.y_slice].reshape(pl.ny, pl.N)
                u = x_full[pl.u_slice].reshape(pl.nu, pl.N)
                wz = jnp.concatenate([y, u], axis=0).T        # (N, nz)
                F = phase_F(i, pl, jt)
                Jw, Jt0, JtF, Js = jax.vmap(
                    jax.jacfwd(F, argnums=(0, 1, 2, 3)),
                    in_axes=(0, None, None, None, 0))(
                        wz, t0, tF, s, jt["tau"].astype(dt))
                Fv = jax.vmap(F, in_axes=(0, None, None, None, 0))(
                    wz, t0, tF, s, jt["tau"].astype(dt))     # (N, nf)
                E = jt["E"].astype(dt)
                I = jt["I"].astype(dt)
                W = jt["W"].astype(dt)
                nd = pl.num_defect
                # Defect rows.
                for kk, k in enumerate(pl.defect_states):
                    rows = pl.c_defect_off + kk * nd + jnp.arange(nd)
                    blk = stretch * I[:, :, None] * Jw[None, :, k, :]
                    J = J.at[rows[:, None, None],
                             st["node_cols"][None, :, :]].add(blk)
                    J = J.at[rows[:, None],
                             st["node_cols"][None, :, k]].add(E)
                    If_k = I @ Fv[:, k]
                    col_t0 = -0.5 * If_k + stretch * (I @ Jt0[:, k])
                    col_tF = 0.5 * If_k + stretch * (I @ JtF[:, k])
                    J = J.at[rows, pl.t_off].add(col_t0)
                    J = J.at[rows, pl.t_off + 1].add(col_tF)
                    if lay.ns:
                        J = J.at[rows[:, None],
                                 lay.s_off + jnp.arange(lay.ns)[None, :]
                                 ].add(stretch * (I @ Js[:, k, :]))
                # Path rows.
                for k in range(pl.npc):
                    rows = pl.c_path_off + k * pl.N + jnp.arange(pl.N)
                    J = J.at[rows[:, None],
                             st["node_cols"]].add(Jw[:, pl.ny + k, :])
                    J = J.at[rows, pl.t_off].add(Jt0[:, pl.ny + k])
                    J = J.at[rows, pl.t_off + 1].add(JtF[:, pl.ny + k])
                    if lay.ns:
                        J = J.at[rows[:, None],
                                 lay.s_off + jnp.arange(lay.ns)[None, :]
                                 ].add(Js[:, pl.ny + k, :])
                # Integral rows.
                iq0 = pl.ny + pl.npc
                for k in range(pl.nq):
                    row = pl.c_integral_off + k
                    J = J.at[row, st["node_cols"]].add(
                        -stretch * W[:, None] * Jw[:, iq0 + k, :])
                    J = J.at[row, pl.q_off + k].add(1.0)
                    Wr = W @ Fv[:, iq0 + k]
                    J = J.at[row, pl.t_off].add(
                        0.5 * Wr - stretch * (W @ Jt0[:, iq0 + k]))
                    J = J.at[row, pl.t_off + 1].add(
                        -0.5 * Wr - stretch * (W @ JtF[:, iq0 + k]))
                    if lay.ns:
                        J = J.at[row,
                                 lay.s_off + jnp.arange(lay.ns)].add(
                            -stretch * (W @ Js[:, iq0 + k, :]))
            # Endpoint rows: nb is small; reverse-mode through the
            # endpoint extraction is cheap and exact.
            if lay.nb:
                def b_of(xf):
                    return program.endpoint_constraints(
                        self.endpoints_of(xf))
                J = J.at[lay.c_endpoint_off:, :].add(jax.jacrev(b_of)(
                    x_full))
            return J

        # derivative_level (reference ``pycollo/settings.py`` derivative
        # level 1/2): level 2 = exact Lagrangian Hessian; level 1 =
        # Gauss-Newton — second derivatives of the user's dynamics/path/
        # integrand and endpoint constraints are dropped (the analogue of
        # the reference handing IPOPT first derivatives only and letting
        # it quasi-Newton the rest), keeping only the objective curvature.
        exact_hessian = self.settings.derivative_level == 2

        def hess_full(x_full, eta):
            """Dense (n_full, n_full) Hessian of eta . c_raw + w J.

            Dtype-polymorphic (see ``jac_full``)."""
            s = x_full[lay.s_slice]
            dt = x_full.dtype
            eta = eta.astype(dt)
            H = jnp.zeros((n_full, n_full), dt)
            for i, (pl, jt, st) in enumerate(zip(
                    lay.phases if exact_hessian else [], jtables,
                    phase_static)):
                t0 = x_full[pl.t_off]
                tF = x_full[pl.t_off + 1]
                y = x_full[pl.y_slice].reshape(pl.ny, pl.N)
                u = x_full[pl.u_slice].reshape(pl.nu, pl.N)
                wz = jnp.concatenate([y, u], axis=0).T
                nd = pl.num_defect
                I = jt["I"].astype(dt)
                W = jt["W"].astype(dt)
                # Per-node multiplier weights.
                kappa_f = jnp.zeros((pl.N, pl.ny), dt)
                for kk, k in enumerate(pl.defect_states):
                    eta_k = jax.lax.dynamic_slice(
                        eta, (pl.c_defect_off + kk * nd,), (nd,))
                    kappa_f = kappa_f.at[:, k].set(I.T @ eta_k)
                eta_p = jax.lax.dynamic_slice(
                    eta, (pl.c_path_off,), (pl.npc * pl.N,)).reshape(
                        pl.npc, pl.N) if pl.npc else jnp.zeros((0, pl.N))
                eta_i = jax.lax.dynamic_slice(
                    eta, (pl.c_integral_off,), (pl.nq,)) if pl.nq \
                    else jnp.zeros(0)
                pf = program.phase_functions[i]

                def phi(vec, kf_j, ep_j, W_j, tau_j):
                    nz = st["nz"]
                    yv = vec[:pl.ny]
                    uv = vec[pl.ny:nz]
                    t0v = vec[nz]
                    tFv = vec[nz + 1]
                    sv = vec[nz + 2:]
                    stretch_v = 0.5 * (tFv - t0v)
                    t_j = stretch_v * tau_j + 0.5 * (t0v + tFv)
                    val = stretch_v * (kf_j @ pf.dynamics(yv, uv, t_j, sv))
                    if pl.npc:
                        val = val + ep_j @ pf.path(yv, uv, t_j, sv)
                    if pl.nq:
                        val = val - stretch_v * W_j * (
                            eta_i @ pf.integrand(yv, uv, t_j, sv))
                    return val

                vecs = jnp.concatenate(
                    [wz,
                     jnp.broadcast_to(t0, (pl.N, 1)),
                     jnp.broadcast_to(tF, (pl.N, 1)),
                     jnp.broadcast_to(s, (pl.N, lay.ns))], axis=1)
                blocks = jax.vmap(jax.hessian(phi),
                                  in_axes=(0, 0, 1, 0, 0))(
                    vecs, kappa_f, eta_p, W,
                    jt["tau"].astype(dt))   # (N, D, D)
                H = H.at[st["hess_idx"][:, :, None],
                         st["hess_idx"][:, None, :]].add(blocks)
            # Endpoint/objective part over the endpoint-relevant entries.
            def ep_val(x_ep):
                xf = x_full.at[ep_idx].set(x_ep)
                ep = self.endpoints_of(xf)
                val = self.w * program.objective(ep)
                if lay.nb and exact_hessian:
                    eta_b = jax.lax.dynamic_slice(
                        eta, (lay.c_endpoint_off,), (lay.nb,))
                    val = val + eta_b @ program.endpoint_constraints(ep)
                return jnp.squeeze(val)

            Hep = jax.hessian(ep_val)(x_full[ep_idx])
            H = H.at[ep_idx[:, None], ep_idx[None, :]].add(Hep)
            return H

        def jac_c_scaled(xs, theta):
            # self.W_c is read at trace time (scaling is built before the
            # solver jits these).
            dt = theta.dtype
            jW_c = jnp.asarray(self.W_c, dt)
            x_full = self.assemble_full(xs, theta)
            J = jac_full(x_full)
            return (jW_c[:, None] * J[:, free_idx]) \
                * V_free.astype(dt)[None, :]

        def hess_lag_scaled(xs, lam, theta):
            dt = theta.dtype
            jW_c = jnp.asarray(self.W_c, dt)
            x_full = self.assemble_full(xs, theta)
            eta = jW_c * lam.astype(dt)
            H = hess_full(x_full, eta)
            Hf = H[free_idx[:, None], free_idx[None, :]]
            Vf = V_free.astype(dt)
            return Hf * Vf[:, None] * Vf[None, :]

        self.jac_c_scaled = jac_c_scaled
        self.hess_lag_scaled = hess_lag_scaled
        self._jac_full_fn = jac_full
        self._hess_full_fn = hess_full
        self._structured_derivs = dict(jac_c=jac_c_scaled,
                                       hess_lag=hess_lag_scaled)
        return self._structured_derivs

    def _expand_W_ocp(self, W_ocp):
        """Expand per-OCP-constraint scales to the mesh-row vector
        (``pycollo/scaling.py:252-269``).  Returns (W_c, W_ocp); a None
        input produces all-ones at both granularities."""
        lay = self.layout
        n_ocp = sum(len(pl.defect_states) + pl.npc + pl.nq
                    for pl in lay.phases) + lay.nb
        if W_ocp is None:
            W_ocp = np.ones(n_ocp)
        W_c = np.ones(lay.m_total)
        off = 0
        for pl in lay.phases:
            nd_states = len(pl.defect_states)
            W_c[pl.c_defect_off:pl.c_path_off] = np.repeat(
                W_ocp[off:off + nd_states], pl.num_defect)
            off += nd_states
            if pl.npc:
                W_c[pl.c_path_off:pl.c_integral_off] = np.repeat(
                    W_ocp[off:off + pl.npc], pl.N)
                off += pl.npc
            if pl.nq:
                W_c[pl.c_integral_off:pl.c_integral_off + pl.nq] = \
                    W_ocp[off:off + pl.nq]
                off += pl.nq
        if lay.nb:
            W_c[lay.c_endpoint_off:] = W_ocp[off:off + lay.nb]
        return W_c, W_ocp

    # -- scaling ---------------------------------------------------------
    def _build_scaling(self):
        """Objective / constraint scaling (``pycollo/scaling.py:271-430``).

        Runs entirely on the host CPU backend: this is one-time setup
        work at the guess (a single dense Jacobian + two gradients), not
        worth compiling for the accelerator.
        """
        import jax
        import jax.numpy as jnp
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            self._build_scaling_on_device()

    def _build_scaling_on_device(self):
        import jax
        import jax.numpy as jnp
        lay = self.layout
        xs0 = jnp.asarray(self.xs_guess)
        theta0 = jnp.asarray(self.theta_default)
        method = self.settings.scaling_method

        # The objective scale must exist before the structured Hessian
        # builder captures it; the gradient layer below refines it.
        self.w = 1.0
        self.w_base = 1.0
        use_update = (self.settings.update_scaling and self.number > 1
                      and method != "none")
        if method == "none":
            self.W_c = np.ones(lay.m_total)
            self.W_ocp = self._expand_W_ocp(None)[1]
        else:
            # Constraint scales (per OCP constraint): defect rows 1/V_y,
            # integral rows 1/V_q, path/endpoint rows 1/(mean row norms of
            # G at the guess) (``pycollo/scaling.py:370-430``).  G comes
            # from the structured per-node assembly (far cheaper to
            # compile than whole-program jacrev).
            self._build_structured_derivatives()
            V_free = self.V_full[self.free_idx]
            x_full0 = jnp.asarray(self.x_full_guess)
            G = np.asarray(jax.jit(self._jac_full_fn)(x_full0))
            G = G[:, self.free_idx] * V_free[None, :]
            G_norm = np.sqrt((G ** 2).sum(axis=1))
            W_parts = []
            for pl, pb in zip(lay.phases, self.compiled.phase_bounds):
                Vy = self.V_full[pl.y_slice].reshape(pl.ny, pl.N)[:, 0]
                W_parts.append(1.0 / Vy[pl.defect_states])
                if pl.npc:
                    rows = G_norm[pl.c_path_off:pl.c_integral_off]
                    mean_rows = rows.reshape(pl.npc, pl.N).mean(axis=1)
                    W_parts.append(1.0 / np.maximum(mean_rows, 1e-8))
                if pl.nq:
                    W_parts.append(1.0 / self.V_full[pl.q_slice])
            if lay.nb:
                W_parts.append(
                    1.0 / np.maximum(G_norm[lay.c_endpoint_off:], 1e-8))
            W_ocp = np.concatenate(W_parts) if W_parts else np.zeros(0)
            # EWMA across mesh iterations (``pycollo/scaling.py:283-344``,
            # gated by ``settings.update_scaling``, weight alpha).
            if use_update:
                prev = self.compiled.mesh_iterations
                weights = self._ewma_weights(len(prev) + 1)
                W_ocp = np.average(
                    np.vstack([[p.W_ocp for p in prev], W_ocp[None]]),
                    axis=0, weights=weights)
            self.W_ocp = W_ocp
            W_c = self._expand_W_ocp(W_ocp)[0]
            # IPOPT-style gradient-based row scaling on top of the
            # reference-parity scales: the reference hands its scaled NLP
            # to IPOPT, whose default ``nlp_scaling_method =
            # gradient-based`` further caps each row's max gradient at
            # 100.  Without this layer, stiff problems (large
            # time-stretch factors) leave defect rows with gradients in
            # the hundreds and the merit line search collapses.
            G_inf = np.abs(G * W_c[:, None]).max(axis=1)
            W_c *= np.minimum(1.0, 100.0 / np.maximum(G_inf, 1e-8))
            self.W_c = W_c
            # Objective scale w: 1.0 on the first mesh iteration, then
            # 1/||grad J|| at the guess (``pycollo/scaling.py:271-281``),
            # EWMA-averaged with previous iterations when
            # ``update_scaling`` (``pycollo/scaling.py:283-293``).
            if self.number == 1:
                self.w_base = 1.0
            else:
                g = np.asarray(jax.grad(self.f_unscaled)(xs0, theta0))
                g_norm = float(np.sqrt((g ** 2).sum()))
                w_cand = 1.0 if np.isclose(g_norm, 0.0) else 1.0 / g_norm
                if use_update:
                    prev = self.compiled.mesh_iterations
                    weights = self._ewma_weights(len(prev) + 1)
                    w_cand = float(np.average(
                        np.array([p.w_base for p in prev] + [w_cand]),
                        weights=weights))
                self.w_base = w_cand
            self.w = self.w_base
            gJ = np.asarray(jax.grad(self.f_unscaled)(xs0, theta0))
            gJ_inf = float(np.abs(self.w * gJ).max())
            self.w *= min(1.0, 100.0 / max(gJ_inf, 1e-8))

        jW_c = self._jnp.asarray(self.W_c)
        w = self.w

        def f_scaled(xs, theta):
            return w * self.f_unscaled(xs, theta)

        def c_scaled(xs, theta):
            return jW_c * self.c_unscaled(xs, theta)

        self.f_scaled = f_scaled
        self.c_scaled = c_scaled
        self.cl_scaled = self.W_c * self.cl
        self.cu_scaled = self.W_c * self.cu

    # -- solve ------------------------------------------------------------
    def build_kkt_operator(self):
        """Scaled-space banded-arrowhead KKT operator for the IPM.

        Wraps :class:`solver.block_kkt.BlockKKT` (which works on the
        full/unscaled variable layout) with the scaled-free-space
        interface the solver's ``compute_step_structured`` expects.
        This is the ``linear_solver = "block-banded"`` path replacing
        the reference's MUMPS sparse factorization
        (``pycollo/backend.py:1695-1711``).
        """
        from .solver.block_kkt import BlockKKT
        jnp = self._jnp
        block = BlockKKT(self)
        it = self

        class _ScaledKKT:
            def assemble(self, xs, theta, lam, sig_free, dinv_rows):
                x_full = it.assemble_full(xs, theta)
                eta = jnp.asarray(it.W_c) * lam
                return block.assemble(x_full, eta, sig_free, dinv_rows)

            def factor(self, blocks, dw):
                return block.factor(blocks, dw)

            def solve(self, blocks, factors, rhs):
                return block.solve(blocks, factors, rhs)

            def kmul(self, blocks, dw, dx):
                return block.kmul(blocks, dw, dx)

        return _ScaledKKT()

    def build_solver(self, options=None, use_structured=True):
        from .solver.ipm import IPMOptions, build_ipm_solver
        if options is None:
            options = IPMOptions(tol=self.settings.nlp_tolerance,
                                 max_iter=self.settings.max_nlp_iterations,
                                 mu_init=self.settings.ipm_mu_init,
                                 mu_min=self.settings.ipm_mu_min,
                                 line_search=self.settings.ipm_line_search,
                                 inertia=self.settings.ipm_inertia)
        if use_structured:
            derivatives = dict(self._build_structured_derivatives())
            if self.settings.linear_solver == "block-banded":
                derivatives["kkt"] = self.build_kkt_operator()
        else:
            derivatives = None
        self._solver = build_ipm_solver(self.f_scaled, self.c_scaled,
                                        self.xs_lb, self.xs_ub,
                                        self.cl_scaled, self.cu_scaled,
                                        options, derivatives=derivatives)
        self._solve_fn = self._jax.jit(self._solver)
        self._solve_warm_fn = self._jax.jit(self._solver.warm)
        return self._solver

    def solve(self, theta=None, warm=None):
        """Solve this mesh iteration's NLP; returns an IterationResult.

        ``warm`` is an optional dict with keys ``lam`` (m,), ``zl``/``zu``
        (n_free,), ``mu`` (scalar) interpolated from the previous mesh
        iteration (see ``refinement.build_warm_start``).
        """
        import time
        if self._solver is None:
            self.build_solver()
        if theta is None:
            theta = self.theta_default
        t0 = time.perf_counter()
        jnp = self._jnp
        if warm is None:
            res = self._solve_fn(jnp.asarray(self.xs_guess),
                                 jnp.asarray(theta))
        else:
            res = self._solve_warm_fn(jnp.asarray(self.xs_guess),
                                      jnp.asarray(theta),
                                      jnp.asarray(warm["lam"]),
                                      jnp.asarray(warm["zl"]),
                                      jnp.asarray(warm["zu"]),
                                      jnp.asarray(warm["mu"]))
        res.x.block_until_ready()
        solve_time = time.perf_counter() - t0
        self.profiler.add("NLP solve", solve_time)
        x_full = np.asarray(self.assemble_full(res.x,
                                               self._jnp.asarray(theta)))
        return IterationResult(iteration=self, ipm_result=res,
                               x_full=x_full, solve_time=solve_time)

    def dump_nlp_check_values(self, path: Optional[str] = None):
        """Dump NLP function values at the guess to JSON.

        Parity with the reference's ``check_nlp_functions`` debug dump
        (``pycollo/iteration.py:1210-1239``, ``pycollo/settings.py:360-365``).
        """
        import json

        import jax
        jnp = self._jnp
        xs0 = jnp.asarray(self.xs_guess)
        theta0 = jnp.asarray(self.theta_default)
        data = {
            "x_scaled_guess": np.asarray(xs0).tolist(),
            "J_scaled": float(self.f_scaled(xs0, theta0)),
            "g_scaled": np.asarray(
                jax.grad(self.f_scaled)(xs0, theta0)).tolist(),
            "c_scaled": np.asarray(self.c_scaled(xs0, theta0)).tolist(),
            "constraint_scales_W": self.W_c.tolist(),
            "objective_scale_w": float(self.w),
        }
        path = path or f"nlp_check_values_iter{self.number}.json"
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
        return path


@dataclass
class IterationResult:
    """Raw solve output for one mesh iteration."""

    iteration: MeshIteration
    ipm_result: object
    x_full: np.ndarray
    solve_time: float

    @property
    def objective(self) -> float:
        """Unscaled objective (``pycollo/scaling.py:186-189``)."""
        return float(self.ipm_result.f) / self.iteration.w

    @property
    def converged(self) -> bool:
        return bool(self.ipm_result.converged)
