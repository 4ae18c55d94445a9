"""Structured (block-banded arrowhead) condensed KKT operator.

This module assembles the condensed-space KKT matrix of a collocation
NLP *directly in banded form* from per-node derivative blocks — the
On-device equivalent of the sparse-AD + MUMPS pipeline in the reference
(hSAD block assembly ``pycollo/compiled.py:213-539``; MUMPS
factorization configured at ``pycollo/backend.py:1695-1711``; the
time-banded/arrowhead block pattern is the reference's Hessian sparsity,
``pycollo/iteration.py:1039-1052``).

Structure exploited (see ``solver/banded.py`` for the factorization):

* **Defect constraints** couple only the nodes of one mesh section;
  adjacent sections share a boundary node -> after condensation the
  node-variable block of K is block *tridiagonal over sections* with
  off-diagonal blocks supported on the shared node's ``nz`` columns.
* **Path constraints** and the barrier/Hessian node blocks are
  node-diagonal.
* **Border** variables — the endpoint nodes ``z0``/``zend`` (coupled
  globally by the endpoint objective/constraints), integrals ``q``,
  phase times ``t0/tF`` and global parameters ``s`` — form a small dense
  arrowhead border.
* **Integral constraints** touch every node through the quadrature
  weights: rank-``nq`` rows handled by a Woodbury correction.
* **Endpoint constraints** touch only border variables: folded into the
  dense border block.

Everything here is gather/einsum with *static* index maps (the mesh is
static per iteration), so the jitted program is compact — no
O(m x n) dense Jacobian scatter, no O(n^2) Hessian, and compile size is
independent of the mesh beyond one ``lax.scan``.

Variable pinning (equal lower/upper bounds -> moved to ``theta``,
``pycollo/bounds.py:901-935``) is handled by zeroing the pinned columns'
scale factors and placing 1 on their diagonal: pinned rows solve to a
zero displacement without changing the layout.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .banded import (ArrowBlocks, PhaseBand, arrow_factor, arrow_solve,
                     btd_solve)


class _PhaseStatic(NamedTuple):
    """Static (numpy, trace-time) metadata for one phase."""

    nz: int
    nf: int
    n_max: int
    mb: int
    MB: int
    Kg: int
    o_idx: np.ndarray        # (K,) first-node slot per section
    sec_node: np.ndarray     # (K, n_max) global node id, -1 pad
    group_node: np.ndarray   # (K, mb) global node id, -1 pad
    I_sec: np.ndarray        # (K, n_max-1, n_max) integration blocks
    E_sec: np.ndarray        # (K, n_max-1, n_max) difference pattern
    W_d: np.ndarray          # (K, n_max-1, nd) defect row scales (W_c)
    d_rows: np.ndarray       # (K, n_max-1, nd) defect row ids into c
    Vz_sec: np.ndarray       # (K, n_max, nz) column scales (0 = pinned/pad)
    Vz_node: np.ndarray      # (N, nz) column scales per node
    node_var: np.ndarray     # (N, nz) full-layout variable index
    first_mask: np.ndarray   # (K, n_max) 1 everywhere except first node col
    # border positions (global border layout offsets)
    z0_off: int
    zend_off: int
    q_off: int
    t_off: int


class BlockKKT:
    """Banded-arrowhead KKT operator for one :class:`MeshIteration`.

    Produces, for the interior-point solver:

    * ``assemble(x_full, eta, sig_free, dinv_rows) -> ArrowBlocks``
    * ``factor(blocks, dw) -> (ArrowFactors)`` (vmappable over ``dw``)
    * ``solve(blocks, factors, rhs_free) -> dx_free``
    * ``kmul(blocks, dw, dx_free) -> K @ dx`` (for iterative refinement)
    """

    def __init__(self, iteration):
        import jax.numpy as jnp
        self._jnp = jnp
        self.it = iteration
        lay = iteration.layout
        self.lay = lay
        self.n_full = lay.n_full

        # Column scales: V for free variables, 0 for pinned (their rows
        # become identity; displacement forced to zero).
        Vcol = np.where(iteration.free_mask, iteration.V_full, 0.0)
        self.Vcol = Vcol
        self.free_idx = iteration.free_idx

        # ---- border layout ------------------------------------------
        border_idx: List[int] = []
        self.phase_static: List[_PhaseStatic] = []
        for pl, t in zip(lay.phases, iteration.tables):
            nz = pl.ny + pl.nu
            node_var = np.empty((pl.N, nz), dtype=np.int64)
            for l in range(pl.ny):
                node_var[:, l] = pl.y_off + l * pl.N + np.arange(pl.N)
            for l in range(pl.nu):
                node_var[:, pl.ny + l] = pl.u_off + l * pl.N \
                    + np.arange(pl.N)
            z0_off = len(border_idx)
            border_idx.extend(node_var[0])
            zend_off = len(border_idx)
            border_idx.extend(node_var[-1])
            q_off = len(border_idx)
            border_idx.extend(range(pl.q_off, pl.q_off + pl.nq))
            t_off = len(border_idx)
            border_idx.extend([pl.t_off, pl.t_off + 1])

            K = t.K
            n_max = int(t.section_nodes.max())
            mb = n_max - 1
            nd = len(pl.defect_states)
            o_idx = (n_max - t.section_nodes).astype(np.int64)
            sec_node = np.full((K, n_max), -1, dtype=np.int64)
            I_sec = np.zeros((K, n_max - 1, n_max))
            E_sec = np.zeros((K, n_max - 1, n_max))
            W_d = np.zeros((K, n_max - 1, nd))
            d_rows = np.full((K, n_max - 1, nd), lay.m_total,
                             dtype=np.int64)   # pad rows -> sentinel
            first_mask = np.ones((K, n_max))
            row = 0
            for k in range(K):
                n_k = int(t.section_nodes[k])
                o = int(o_idx[k])
                start = int(t.section_starts[k])
                sec_node[k, o:] = start + np.arange(n_k)
                # Slice the per-section operators out of the global
                # (static) tables built by mesh.build_phase_tables.
                I_sec[k, o:, o:] = t.I[row:row + n_k - 1,
                                       start:start + n_k]
                E_sec[k, o:, o:] = t.E[row:row + n_k - 1,
                                       start:start + n_k]
                for li, l in enumerate(pl.defect_states):
                    rows = pl.c_defect_off + li * pl.num_defect \
                        + row + np.arange(n_k - 1)
                    W_d[k, o:, li] = iteration.W_c[rows]
                    d_rows[k, o:, li] = rows
                first_mask[k, o] = 0.0
                row += n_k - 1
            # group slot g holds node slot g+1 of section k; the last
            # group's final real slot is the phase end node -> border.
            # A section's FIRST node (slot o_k) belongs to the previous
            # group (it is group k-1's last slot), so it must not appear
            # in group k (only relevant when n_k < n_max, i.e. o_k >= 1).
            group_node = sec_node[:, 1:].copy()
            for k in range(K):
                if o_idx[k] >= 1:
                    group_node[k, o_idx[k] - 1] = -1
            group_node[K - 1, n_max - 2] = -1
            Vz_node = Vcol[node_var]
            Vz_sec = np.where(sec_node[..., None] >= 0,
                              Vz_node[np.clip(sec_node, 0, None)], 0.0)
            nf = pl.ny + pl.npc + pl.nq
            self.phase_static.append(_PhaseStatic(
                nz=nz, nf=nf, n_max=n_max, mb=mb, MB=mb * nz, Kg=K,
                o_idx=o_idx, sec_node=sec_node, group_node=group_node,
                I_sec=I_sec, E_sec=E_sec, W_d=W_d, d_rows=d_rows,
                Vz_sec=Vz_sec, Vz_node=Vz_node, node_var=node_var,
                first_mask=first_mask,
                z0_off=z0_off, zend_off=zend_off, q_off=q_off,
                t_off=t_off))
        self.s_off_border = len(border_idx)
        border_idx.extend(range(lay.s_off, lay.s_off + lay.ns))
        self.border_idx = np.asarray(border_idx, dtype=np.int64)
        self.nw = len(border_idx)
        self.Vw = Vcol[self.border_idx]
        self.wmask = (self.Vw != 0.0).astype(float)

        # free-space <-> structured-space static maps
        self._free_of_full = np.full(lay.n_full + 1, -1, dtype=np.int64)
        self._free_of_full[iteration.free_idx] = np.arange(
            len(iteration.free_idx))
        # z gather maps (pad/pinned -> sentinel n_full, reads 0)
        self.zmaps = []
        self.zmasks = []
        for ps in self.phase_static:
            gm = np.where(ps.group_node[..., None] >= 0,
                          ps.node_var[np.clip(ps.group_node, 0, None)],
                          lay.n_full)
            gm = gm.reshape(ps.Kg, ps.MB)
            vz = np.where(gm < lay.n_full, Vcol[np.clip(gm, 0,
                                                        lay.n_full - 1)],
                          0.0)
            zmask = (vz != 0.0).astype(float)
            # pinned/pad entries read from the sentinel too (their rhs
            # and solution entries must be exactly zero).
            gm = np.where(zmask > 0, gm, lay.n_full)
            self.zmaps.append(gm)
            self.zmasks.append(zmask)
        bm = np.where(self.wmask > 0, self.border_idx, lay.n_full)
        self.border_map = bm

        # low-rank (integral-row) column count
        self.nr = sum(pl.nq for pl in lay.phases)

        self._node_fns = None
        self._border_hess_fn = None
        # Build the cached per-node closures EAGERLY (outside any jit
        # trace): they capture jnp constants, and a constant created
        # inside a trace is a tracer — caching it would leak it into
        # every later trace of the same operator.
        self._build_node_functions()
        self._build_border_hess()

    # ------------------------------------------------------------------
    def _build_node_functions(self):
        """Per-node user-function derivative evaluators (one vmap each)."""
        if self._node_fns is not None:
            return self._node_fns
        import jax
        import jax.numpy as jnp
        it = self.it
        lay = self.lay
        program = it.compiled.program
        fns = []
        for i, (pl, t) in enumerate(zip(lay.phases, it.tables)):
            pf = program.phase_functions[i]
            ps = self.phase_static[i]
            nz, ns = ps.nz, lay.ns
            tau = jnp.asarray(t.tau)

            def F(vec, tau_j, pl=pl, pf=pf, nz=nz):
                y = vec[:pl.ny]
                u = vec[pl.ny:nz]
                t0v = vec[nz]
                tFv = vec[nz + 1]
                sv = vec[nz + 2:]
                t_j = 0.5 * (tFv - t0v) * tau_j + 0.5 * (t0v + tFv)
                parts = [pf.dynamics(y, u, t_j, sv)]
                if pl.npc:
                    parts.append(pf.path(y, u, t_j, sv))
                if pl.nq:
                    parts.append(pf.integrand(y, u, t_j, sv))
                return jnp.concatenate(parts)

            def node_jac(x_full, F=F, pl=pl, tau=tau, nz=nz):
                y = x_full[pl.y_slice].reshape(pl.ny, pl.N)
                u = x_full[pl.u_slice].reshape(pl.nu, pl.N)
                wz = jnp.concatenate([y, u], axis=0).T
                vecs = jnp.concatenate(
                    [wz,
                     jnp.broadcast_to(x_full[pl.t_off], (pl.N, 1)),
                     jnp.broadcast_to(x_full[pl.t_off + 1], (pl.N, 1)),
                     jnp.broadcast_to(x_full[lay.s_slice],
                                      (pl.N, lay.ns))], axis=1)
                Fv = jax.vmap(F)(vecs, tau)               # (N, nf)
                Jn = jax.vmap(jax.jacfwd(F))(vecs, tau)   # (N, nf, D)
                return Fv, Jn, vecs

            def node_hess(x_full, eta, F=F, pl=pl, ps=ps, t=t, tau=tau):
                """Per-node Lagrangian-Hessian blocks (N, D, D).

                ``phi_full`` is the per-node share of eta . c(x): the
                defect/integral stretch factor 0.5*(tF - t0) is part of
                the differentiated expression so the t0/tF rows and the
                cross terms with z are exact.
                """
                y = x_full[pl.y_slice].reshape(pl.ny, pl.N)
                u = x_full[pl.u_slice].reshape(pl.nu, pl.N)
                wz = jnp.concatenate([y, u], axis=0).T
                vecs = jnp.concatenate(
                    [wz,
                     jnp.broadcast_to(x_full[pl.t_off], (pl.N, 1)),
                     jnp.broadcast_to(x_full[pl.t_off + 1], (pl.N, 1)),
                     jnp.broadcast_to(x_full[lay.s_slice],
                                      (pl.N, lay.ns))], axis=1)
                I_g = jnp.asarray(t.I)
                W_g = jnp.asarray(t.W)
                nd = pl.num_defect
                kappa_f = jnp.zeros((pl.N, pl.ny))
                for kk, k in enumerate(pl.defect_states):
                    eta_k = jax.lax.dynamic_slice(
                        eta, (pl.c_defect_off + kk * nd,), (nd,))
                    kappa_f = kappa_f.at[:, k].set(I_g.T @ eta_k)
                eta_p = jax.lax.dynamic_slice(
                    eta, (pl.c_path_off,), (pl.npc * pl.N,)).reshape(
                        pl.npc, pl.N).T if pl.npc \
                    else jnp.zeros((pl.N, 0))
                eta_i = jax.lax.dynamic_slice(
                    eta, (pl.c_integral_off,), (pl.nq,)) if pl.nq \
                    else jnp.zeros(0)

                def phi_full(vec, kf_j, ep_j, W_j, tau_j, pl=pl,
                             nz=ps.nz):
                    t0v = vec[nz]
                    tFv = vec[nz + 1]
                    stretch_v = 0.5 * (tFv - t0v)
                    Fj = F(vec, tau_j)
                    val = stretch_v * (kf_j @ Fj[:pl.ny])
                    if pl.npc:
                        val = val + ep_j @ Fj[pl.ny:pl.ny + pl.npc]
                    if pl.nq:
                        val = val - stretch_v * W_j * (
                            eta_i @ Fj[pl.ny + pl.npc:])
                    return val

                blocks = jax.vmap(jax.hessian(phi_full),
                                  in_axes=(0, 0, 0, 0, 0))(
                    vecs, kappa_f, eta_p, W_g, tau)
                return blocks

            fns.append((node_jac, node_hess))
        self._node_fns = fns
        return fns

    def _build_border_hess(self):
        """Hessian of w*J + eta_b . b over the border variables."""
        if self._border_hess_fn is not None:
            return self._border_hess_fn
        import jax
        import jax.numpy as jnp
        it = self.it
        lay = self.lay
        program = it.compiled.program
        bmap = jnp.asarray(self.border_map)
        w_obj = it.w
        exact = it.settings.derivative_level == 2

        def _with_border(x_full, xw):
            """x_full with border entries replaced (sentinel-safe)."""
            xf_ext = jnp.concatenate([x_full, jnp.zeros(1)])
            xf_ext = xf_ext.at[bmap].set(xw)
            return xf_ext[:lay.n_full]

        def _border_of(x_full):
            x_ext = jnp.concatenate([x_full, jnp.zeros(1)])
            return x_ext[bmap]

        def ep_val(xw, x_full, eta):
            ep = it.endpoints_of(_with_border(x_full, xw))
            val = w_obj * program.objective(ep)
            if lay.nb and exact:
                eta_b = jax.lax.dynamic_slice(
                    eta, (lay.c_endpoint_off,), (lay.nb,))
                val = val + eta_b @ program.endpoint_constraints(ep)
            return jnp.squeeze(val)

        def border_hess(x_full, eta):
            return jax.hessian(ep_val)(_border_of(x_full), x_full, eta)

        def border_jac_b(x_full):
            """Scaled endpoint-constraint Jacobian over border vars."""
            if not lay.nb:
                return jnp.zeros((0, self.nw))
            W_b = jnp.asarray(it.W_c[lay.c_endpoint_off:])

            def b_of(xw, x_full=x_full):
                return W_b * program.endpoint_constraints(
                    it.endpoints_of(_with_border(x_full, xw)))

            return jax.jacrev(b_of)(_border_of(x_full))

        self._border_hess_fn = (border_hess, border_jac_b)
        return self._border_hess_fn

    # ------------------------------------------------------------------
    @staticmethod
    def _psd_clip(jnp, H):
        """Project a (stack of) symmetric blocks onto the PSD cone.

        Eigenvalue clipping per small block: the convexified Lagrangian
        Hessian keeps all positive curvature and drops the negative part
        — a targeted modified-Newton fallback that keeps the banded KKT
        factorizable at dw ~ 0 where the exact-Hessian banded block is
        indefinite (the Woodbury split needs M = K - G D^-1 G^T positive
        definite, strictly stronger than the dense path's K > 0)."""
        w_, V_ = jnp.linalg.eigh(H)
        w_ = jnp.maximum(w_, 0.0)
        return jnp.einsum("...ab,...b,...cb->...ac", V_, w_, V_)

    def assemble(self, x_full, eta, sig_free, dinv_rows):
        """Assemble banded KKT blocks at the current iterate.

        ``eta``: unscaled-space constraint multipliers (W_c * lam).
        ``sig_free``: barrier diagonal over the free (scaled) variables.
        ``dinv_rows``: per-constraint-row 1/D (slack-eliminated dual
        regularization; equality rows 1/dc).

        Returns ``(blocks_exact, blocks_convex)``: the same banded KKT
        with the exact Lagrangian Hessian and with the per-node
        PSD-clipped (convexified) Hessian.  The convexified variant is
        positive definite at dw ~ 0 by construction (every Hessian block
        PSD + the PSD constraint terms + the positive barrier/pin
        diagonal), so the interior-point solver uses it as the last
        speculative inertia level instead of escalating dw to
        step-destroying magnitudes.
        """
        import jax.numpy as jnp
        lay = self.lay
        it = self.it
        node_fns = self._build_node_functions()
        border_hess, border_jac_b = self._build_border_hess()
        exact = it.settings.derivative_level == 2

        nw = self.nw
        B = jnp.zeros((nw, nw))
        BH = {"e": jnp.zeros((nw, nw)), "c": jnp.zeros((nw, nw))}
        Gw = jnp.zeros((nw, self.nr))
        sig_full = jnp.zeros(lay.n_full + 1).at[
            jnp.asarray(self.free_idx)].set(sig_free)
        x_ext = jnp.concatenate([x_full, jnp.zeros(1)])
        dinv_ext = jnp.concatenate([dinv_rows, jnp.zeros(1)])

        phases = []
        phases_H = []
        nr_off = 0
        for i, (pl, ps, t) in enumerate(zip(lay.phases, self.phase_static,
                                            it.tables)):
            node_jac, node_hess = node_fns[i]
            nz, nf, n_max, mb, MB, Kg = (ps.nz, ps.nf, ps.n_max, ps.mb,
                                         ps.MB, ps.Kg)
            nbc = 2 + lay.ns          # border cols: t0, tF, s
            t0 = x_full[pl.t_off]
            tF = x_full[pl.t_off + 1]
            stretch = 0.5 * (tF - t0)

            Fv, Jn, _ = node_jac(x_full)     # (N, nf), (N, nf, D)
            Jw = Jn[:, :, :nz]
            Jt0 = Jn[:, :, nz]
            JtF = Jn[:, :, nz + 1]
            Js = Jn[:, :, nz + 2:]

            sec = jnp.asarray(np.clip(ps.sec_node, 0, None))
            sec_valid = jnp.asarray((ps.sec_node >= 0).astype(float))
            I_sec = jnp.asarray(ps.I_sec)
            E_sec = jnp.asarray(ps.E_sec)
            W_dj = jnp.asarray(ps.W_d)
            Vz_sec = jnp.asarray(ps.Vz_sec)

            # ---- defect rows (section-local) ------------------------
            nd = len(pl.defect_states)
            dstates = np.asarray(pl.defect_states)
            Jw_sec = Jw[sec] * sec_valid[:, :, None, None]  # (K,n,nf,nz)
            Jf_sec = Jw_sec[:, :, dstates, :]               # (K,n,nd,nz)
            # Ad[k, r, l, j, b]
            Ad = stretch * jnp.einsum("krj,kjlb->krljb", I_sec, Jf_sec)
            # E pattern hits the y_l column of z directly.
            eye_y = np.zeros((nd, nz))
            eye_y[np.arange(nd), dstates] = 1.0
            Ad = Ad + jnp.einsum("krj,lb->krljb", E_sec,
                                 jnp.asarray(eye_y))
            # scale rows (W_c) and z-columns (V, pinned -> 0)
            Ad = Ad * W_dj[:, :, :, None, None] \
                * Vz_sec[:, None, None, :, :]
            Rn = (n_max - 1) * nd
            Ad = Ad.reshape(Kg, Rn, n_max, nz)

            # border (t0, tF, s) columns of the defect rows
            IF = jnp.einsum("krj,kjl->krl", I_sec, Fv[sec][:, :, dstates]
                            * sec_valid[:, :, None])
            IJt0 = jnp.einsum("krj,kjl->krl", I_sec,
                              Jt0[sec][:, :, dstates]
                              * sec_valid[:, :, None])
            IJtF = jnp.einsum("krj,kjl->krl", I_sec,
                              JtF[sec][:, :, dstates]
                              * sec_valid[:, :, None])
            col_t0 = -0.5 * IF + stretch * IJt0
            col_tF = 0.5 * IF + stretch * IJtF
            parts = [col_t0[..., None], col_tF[..., None]]
            if lay.ns:
                IJs = jnp.einsum("krj,kjls->krls", I_sec,
                                 Js[sec][:, :, dstates, :]
                                 * sec_valid[:, :, None, None])
                parts.append(stretch * IJs)
            Abord = jnp.concatenate(parts, axis=-1)   # (K, n-1, nd, nbc)
            Vb = jnp.asarray(np.concatenate(
                [[self.Vcol[pl.t_off], self.Vcol[pl.t_off + 1]],
                 self.Vcol[lay.s_off:lay.s_off + lay.ns]]))
            Abord = Abord * W_dj[..., None] * Vb
            Abord = Abord.reshape(Kg, Rn, nbc)

            rwgt = dinv_ext[jnp.asarray(ps.d_rows)].reshape(Kg, Rn)

            # split first-node / last-node(final section) / rest columns
            o_bc = jnp.broadcast_to(
                jnp.asarray(ps.o_idx)[:, None, None, None],
                (Kg, Rn, 1, nz))
            Af = jnp.take_along_axis(Ad, o_bc, axis=2)[:, :, 0, :]
            first_mask = jnp.asarray(ps.first_mask)
            Ar = Ad * first_mask[:, None, :, None]
            Ab = Ar[Kg - 1, :, n_max - 1, :]          # (Rn, nz) end node
            last_mask = np.ones((Kg, n_max))
            last_mask[Kg - 1, n_max - 1] = 0.0
            Ar = Ar * jnp.asarray(last_mask)[:, None, :, None]
            Ar = Ar[:, :, 1:, :].reshape(Kg, Rn, MB)

            ArD = Ar * rwgt[:, :, None]
            Dblk = jnp.einsum("kra,krb->kab", ArD, Ar)
            Ublk = jnp.einsum("kra,krb->kab", ArD, Af)   # (K, MB, nz)
            corner = jnp.einsum("kra,kr,krb->kab", Af, rwgt, Af)
            Dblk = Dblk.at[:-1, MB - nz:, MB - nz:].add(corner[1:])
            Cb_rows = jnp.einsum("krw,kra->kwa", Abord * rwgt[:, :, None],
                                 Ar)                      # (K, nbc, MB)
            Cblk = jnp.zeros((Kg, nw, MB))
            tws = np.concatenate([[ps.t_off, ps.t_off + 1],
                                  np.arange(self.s_off_border,
                                            self.s_off_border + lay.ns)])
            Cblk = Cblk.at[:, jnp.asarray(tws), :].add(Cb_rows)
            # border diag: t/s x t/s from all defect rows
            Btws = jnp.einsum("krw,kr,krv->wv", Abord, rwgt, Abord)
            B = B.at[np.ix_(tws, tws)].add(Btws)
            # first node of section 0 -> z0 border rows
            z0_sl = slice(ps.z0_off, ps.z0_off + nz)
            zend_sl = slice(ps.zend_off, ps.zend_off + nz)
            B = B.at[z0_sl, z0_sl].add(
                jnp.einsum("ra,r,rb->ab", Af[0], rwgt[0], Af[0]))
            cross0 = jnp.einsum("rw,r,ra->wa", Abord[0], rwgt[0], Af[0])
            B = B.at[np.ix_(tws, range(ps.z0_off, ps.z0_off + nz))].add(
                cross0)
            B = B.at[np.ix_(range(ps.z0_off, ps.z0_off + nz), tws)].add(
                cross0.T)
            Cblk = Cblk.at[0, z0_sl, :].add(
                jnp.einsum("ra,r,rm->am", Af[0], rwgt[0], Ar[0]))
            # shared-node coupling of sections k>=1 lives in group k-1's
            # last slot; handled via Ublk (k>=1).  Zero the k=0 entry.
            Ublk = Ublk.at[0].set(0.0)
            # border (t/s) x shared-node cross terms for sections k>=1
            # land in group k-1's last-node columns.
            if Kg >= 2:
                crossAf = jnp.einsum("krw,kr,kra->kwa", Abord, rwgt, Af)
                Cblk = Cblk.at[:Kg - 1, jnp.asarray(tws),
                               MB - nz:].add(crossAf[1:])
            # final-section end node -> zend border rows
            rwl = rwgt[Kg - 1]
            B = B.at[zend_sl, zend_sl].add(
                jnp.einsum("ra,r,rb->ab", Ab, rwl, Ab))
            crossE = jnp.einsum("rw,r,ra->wa", Abord[Kg - 1], rwl, Ab)
            B = B.at[np.ix_(tws, range(ps.zend_off,
                                       ps.zend_off + nz))].add(crossE)
            B = B.at[np.ix_(range(ps.zend_off, ps.zend_off + nz),
                            tws)].add(crossE.T)
            Cblk = Cblk.at[Kg - 1, zend_sl, :].add(
                jnp.einsum("ra,r,rm->am", Ab, rwl, Ar[Kg - 1]))
            if Kg >= 2:
                # zend x shared-node(last group's first node sits in
                # group Kg-2's last slot) cross term via Af[Kg-1]
                crossZ = jnp.einsum("ra,r,rb->ab", Ab, rwl, Af[Kg - 1])
                Cblk = Cblk.at[Kg - 2, zend_sl, MB - nz:].add(crossZ)
            else:
                # single-section phase: first node is z0 border
                crossZ = jnp.einsum("ra,r,rb->ab", Ab, rwl, Af[0])
                B = B.at[zend_sl, z0_sl].add(crossZ)
                B = B.at[z0_sl, zend_sl].add(crossZ.T)

            # ---- path rows (node-diagonal) --------------------------
            gnode = jnp.asarray(np.clip(ps.group_node, 0, None))
            gvalid = jnp.asarray((ps.group_node >= 0).astype(float))
            if pl.npc:
                Wp = jnp.asarray(
                    it.W_c[pl.c_path_off:pl.c_integral_off].reshape(
                        pl.npc, pl.N).T)                    # (N, npc)
                p_rows = np.arange(pl.c_path_off,
                                   pl.c_integral_off).reshape(
                                       pl.npc, pl.N).T      # (N, npc)
                dinv_p = dinv_rows[jnp.asarray(p_rows)]     # (N, npc)
                Vzn = jnp.asarray(ps.Vz_node)
                Pz = Jw[:, pl.ny:pl.ny + pl.npc, :] * Wp[:, :, None] \
                    * Vzn[:, None, :]                       # (N,npc,nz)
                Pb = jnp.stack([Jt0[:, pl.ny:pl.ny + pl.npc],
                                JtF[:, pl.ny:pl.ny + pl.npc]], axis=-1)
                if lay.ns:
                    Pb = jnp.concatenate(
                        [Pb, Js[:, pl.ny:pl.ny + pl.npc, :]], axis=-1)
                Pb = Pb * Wp[:, :, None] * Vb               # (N,npc,nbc)
                PzD = Pz * dinv_p[:, :, None]
                NBlk = jnp.einsum("jpa,jpb->jab", PzD, Pz)  # (N,nz,nz)
                CBlk = jnp.einsum("jpw,jpa->jwa", Pb * dinv_p[:, :, None],
                                  Pz)                       # (N,nbc,nz)
                BB = jnp.einsum("jpw,jp,jpv->wv", Pb, dinv_p, Pb)
                B = B.at[np.ix_(tws, tws)].add(BB)
                Dblk, Cblk, B = self._scatter_node_blocks(
                    ps, pl, NBlk, CBlk, Dblk, Cblk, B, tws, gnode,
                    gvalid)

            # ---- Hessian node blocks (exact + convexified) ----------
            DblkH = {"e": jnp.zeros_like(Dblk), "c": jnp.zeros_like(Dblk)}
            CblkH = {"e": jnp.zeros_like(Cblk), "c": jnp.zeros_like(Cblk)}
            if exact:
                Hn = node_hess(x_full, eta)     # (N, D, D)
                Vzn = jnp.asarray(ps.Vz_node)
                Vext = jnp.concatenate(
                    [Vzn, jnp.broadcast_to(Vb, (pl.N, nbc))], axis=1)
                Hn = Hn * Vext[:, :, None] * Vext[:, None, :]
                for key, Hv in (("e", Hn), ("c", self._psd_clip(jnp, Hn))):
                    Hzz = Hv[:, :nz, :nz]
                    Hzw = Hv[:, nz:, :nz]       # (N, nbc, nz)
                    Hww = Hv[:, nz:, nz:]
                    BH[key] = BH[key].at[np.ix_(tws, tws)].add(
                        Hww.sum(axis=0))
                    DblkH[key], CblkH[key], BH[key] = \
                        self._scatter_node_blocks(
                            ps, pl, Hzz, Hzw, DblkH[key], CblkH[key],
                            BH[key], tws, gnode, gvalid)

            # ---- integral rows (low-rank columns) -------------------
            Gz = jnp.zeros((Kg, MB, self.nr))
            if pl.nq:
                Wi = jnp.asarray(it.W_c[pl.c_integral_off:
                                        pl.c_integral_off + pl.nq])
                W_g = jnp.asarray(t.W)          # (N,)
                Vzn = jnp.asarray(ps.Vz_node)
                iq0 = pl.ny + pl.npc
                # z columns: -stretch * W_j * d rho_l / dz_j
                Gnode = -stretch * W_g[:, None, None] \
                    * Jw[:, iq0:iq0 + pl.nq, :] * Wi[None, :, None] \
                    * Vzn[:, None, :]           # (N, nq, nz)
                # gather into group layout (Kg, mb, nq, nz) -> (Kg, MB, nq)
                Gg = jnp.concatenate(
                    [Gnode, jnp.zeros((1,) + Gnode.shape[1:])], axis=0)[
                        jnp.asarray(np.where(ps.group_node >= 0,
                                             ps.group_node, pl.N))]
                Gg = jnp.swapaxes(Gg, 2, 3).reshape(Kg, MB, pl.nq)
                Gz = Gz.at[:, :, nr_off:nr_off + pl.nq].set(Gg)
                # border rows: q, t0/tF/s, z0, zend
                Wr = W_g @ Fv[:, iq0:iq0 + pl.nq]           # (nq,)
                gt0 = (0.5 * Wr - stretch
                       * (W_g @ Jt0[:, iq0:iq0 + pl.nq])) * Wi \
                    * self.Vcol[pl.t_off]
                gtF = (-0.5 * Wr - stretch
                       * (W_g @ JtF[:, iq0:iq0 + pl.nq])) * Wi \
                    * self.Vcol[pl.t_off + 1]
                Gw = Gw.at[ps.t_off, nr_off:nr_off + pl.nq].add(gt0)
                Gw = Gw.at[ps.t_off + 1, nr_off:nr_off + pl.nq].add(gtF)
                if lay.ns:
                    gs = -stretch * jnp.einsum(
                        "j,jls->sl", W_g, Js[:, iq0:iq0 + pl.nq, :]) \
                        * Wi[None, :] \
                        * jnp.asarray(self.Vcol[lay.s_off:lay.s_off
                                                + lay.ns])[:, None]
                    Gw = Gw.at[self.s_off_border:self.s_off_border
                               + lay.ns, nr_off:nr_off + pl.nq].add(gs)
                # q column: d rho_l / d q_l = 1
                qV = jnp.asarray(self.Vcol[pl.q_off:pl.q_off + pl.nq])
                Gw = Gw.at[ps.q_off + np.arange(pl.nq),
                           nr_off + np.arange(pl.nq)].add(Wi * qV)
                # endpoint-node z columns
                Gw = Gw.at[ps.z0_off:ps.z0_off + nz,
                           nr_off:nr_off + pl.nq].add(Gnode[0].T)
                Gw = Gw.at[ps.zend_off:ps.zend_off + nz,
                           nr_off:nr_off + pl.nq].add(Gnode[pl.N - 1].T)
            nr_off += pl.nq

            # ---- barrier diagonal + identity for pinned/pads --------
            zmap = jnp.asarray(self.zmaps[i])
            zmask = jnp.asarray(self.zmasks[i])
            sig_z = sig_full[zmap] * zmask
            diag_add = sig_z + (1.0 - zmask)
            Dblk = Dblk.at[:, jnp.arange(MB), jnp.arange(MB)].add(
                diag_add)

            phases.append(PhaseBand(Dblk=Dblk, Ublk=Ublk, Cblk=Cblk,
                                    Gz=Gz))
            phases_H.append((DblkH, CblkH))

        # ---- endpoint rows + objective Hessian over the border -------
        Vw = jnp.asarray(self.Vw)
        Hep = border_hess(x_full, eta) * Vw[:, None] * Vw[None, :]
        BH["e"] = BH["e"] + Hep
        BH["c"] = BH["c"] + self._psd_clip(jnp, Hep)
        d_rows_b = np.arange(lay.c_endpoint_off, lay.m_total)
        if lay.nb:
            Jb = border_jac_b(x_full) * Vw[None, :]
            dinv_b = dinv_rows[jnp.asarray(d_rows_b)]
            B = B + jnp.einsum("rw,r,rv->wv", Jb, dinv_b, Jb)
        # barrier diag + identity pins on the border
        sig_w = sig_full[jnp.asarray(self.border_map)] \
            * jnp.asarray(self.wmask)
        B = B + jnp.diag(sig_w + (1.0 - jnp.asarray(self.wmask)))

        # integral-row dual regularization values (D = 1/dinv)
        if self.nr:
            i_rows = np.concatenate(
                [np.arange(pl.c_integral_off, pl.c_integral_off + pl.nq)
                 for pl in lay.phases])
            d_ib = 1.0 / jnp.maximum(dinv_rows[jnp.asarray(i_rows)],
                                     1e-300)
        else:
            d_ib = jnp.zeros(0)

        zmask_t = tuple(jnp.asarray(z) for z in self.zmasks)
        wmask_j = jnp.asarray(self.wmask)

        def variant(key):
            ph = tuple(PhaseBand(Dblk=pb.Dblk + dh[key],
                                 Ublk=pb.Ublk,
                                 Cblk=pb.Cblk + ch[key],
                                 Gz=pb.Gz)
                       for pb, (dh, ch) in zip(phases, phases_H))
            return ArrowBlocks(phases=ph, B=B + BH[key], Gw=Gw,
                               d_ib=d_ib, zmask=zmask_t, wmask=wmask_j)

        return variant("e"), variant("c")

    def _scatter_node_blocks(self, ps, pl, NBlk, CBlk, Dblk, Cblk, B,
                             tws, gnode, gvalid):
        """Scatter per-node (nz,nz)/(nbc,nz) blocks into band/border."""
        import jax.numpy as jnp
        nz, mb, MB, Kg = ps.nz, ps.mb, ps.MB, ps.Kg
        # interior nodes -> group block-diagonal
        NB_ext = jnp.concatenate(
            [NBlk, jnp.zeros((1,) + NBlk.shape[1:])], axis=0)
        gidx = jnp.asarray(np.where(ps.group_node >= 0, ps.group_node,
                                    pl.N))
        NB_g = NB_ext[gidx]                      # (Kg, mb, nz, nz)
        slots = jnp.arange(mb)
        Dexp = jnp.zeros((Kg, mb, nz, mb, nz))
        Dexp = Dexp.at[:, slots, :, slots, :].set(
            jnp.moveaxis(NB_g, 1, 0)).reshape(Kg, MB, MB)
        Dblk = Dblk + Dexp
        # interior nodes -> border coupling rows
        CB_ext = jnp.concatenate(
            [CBlk, jnp.zeros((1,) + CBlk.shape[1:])], axis=0)
        CB_g = CB_ext[gidx]                      # (Kg, mb, nbc, nz)
        CB_g = jnp.moveaxis(CB_g, 2, 1).reshape(Kg, -1, MB)
        Cblk = Cblk.at[:, jnp.asarray(tws), :].add(CB_g)
        # endpoint nodes -> border
        z0_sl = slice(ps.z0_off, ps.z0_off + nz)
        zend_sl = slice(ps.zend_off, ps.zend_off + nz)
        B = B.at[z0_sl, z0_sl].add(NBlk[0])
        B = B.at[zend_sl, zend_sl].add(NBlk[pl.N - 1])
        B = B.at[np.ix_(tws, range(ps.z0_off, ps.z0_off + nz))].add(
            CBlk[0])
        B = B.at[np.ix_(range(ps.z0_off, ps.z0_off + nz), tws)].add(
            CBlk[0].T)
        B = B.at[np.ix_(tws, range(ps.zend_off, ps.zend_off + nz))].add(
            CBlk[pl.N - 1])
        B = B.at[np.ix_(range(ps.zend_off, ps.zend_off + nz), tws)].add(
            CBlk[pl.N - 1].T)
        return Dblk, Cblk, B

    # ------------------------------------------------------------------
    def factor(self, blocks, dw):
        return arrow_factor(blocks, dw)

    def _rhs_to_struct(self, rhs_free):
        import jax.numpy as jnp
        rhs_full = jnp.zeros(self.n_full + 1).at[
            jnp.asarray(self.free_idx)].set(rhs_free)
        rz = [rhs_full[jnp.asarray(zm)] for zm in self.zmaps]
        rw = rhs_full[jnp.asarray(self.border_map)]
        return rz, rw

    def _struct_to_free(self, dz_list, dw_vec):
        import jax.numpy as jnp
        out = jnp.zeros(self.n_full + 1)
        for zm, dz in zip(self.zmaps, dz_list):
            out = out.at[jnp.asarray(zm)].add(dz)
        out = out.at[jnp.asarray(self.border_map)].add(dw_vec)
        return out[jnp.asarray(self.free_idx)]

    def solve(self, blocks, factors, rhs_free):
        rz, rw = self._rhs_to_struct(rhs_free)
        dz, dw_vec = arrow_solve(factors, rz, rw)
        return self._struct_to_free(dz, dw_vec)

    def kmul(self, blocks, dw, dx_free):
        """K @ dx in free space (for iterative refinement)."""
        import jax.numpy as jnp
        rz, rw = self._rhs_to_struct(dx_free)
        out_z = []
        out_w = jnp.zeros(self.nw)
        gsum = jnp.zeros(self.nr)
        for pb, z, zm in zip(blocks.phases, rz, blocks.zmask):
            K, MB, _ = pb.Dblk.shape
            nz = pb.Ublk.shape[-1]
            oz = jnp.einsum("kab,kb->ka", pb.Dblk, z)
            # sub-diagonal couplings
            z_prev_tail = jnp.concatenate(
                [jnp.zeros((1, nz)), z[:-1, MB - nz:]], axis=0)
            oz = oz + jnp.einsum("kab,kb->ka", pb.Ublk, z_prev_tail)
            up = jnp.einsum("kab,ka->kb", pb.Ublk, z)      # (K, nz)
            oz = oz.at[:-1, MB - nz:].add(up[1:])
            oz = oz + jnp.einsum("kwa,w->ka", pb.Cblk, rw)
            oz = oz + dw * zm * z
            out_w = out_w + jnp.einsum("kwa,ka->w", pb.Cblk, z)
            gsum = gsum + jnp.einsum("kar,ka->r", pb.Gz, z)
            out_z.append(oz)
        out_w = out_w + blocks.B @ rw + dw * blocks.wmask * rw
        gsum = gsum + blocks.Gw.T @ rw
        coef = gsum / jnp.maximum(blocks.d_ib, 1e-300) \
            if self.nr else gsum
        out_z = [oz + pb.Gz @ coef
                 for oz, pb in zip(out_z, blocks.phases)]
        out_w = out_w + blocks.Gw @ coef
        return self._struct_to_free(out_z, out_w)
