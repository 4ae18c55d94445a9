"""Batched / sharded solves of one OCP over many instances.

This is new capability relative to the serial reference (SURVEY.md section 2
"absent" rows): the compiled NLP of a mesh iteration is a pure function of
``(x0_scaled, theta)``, so thousands of perturbed instances (different
initial states, endpoint targets, fixed times or parameters — any entry of
``theta``) solve simultaneously with ``vmap``, and the batch axis shards
across devices with ``jax.sharding`` (data-parallel): the
batched solve is jitted with a ``NamedSharding`` over the instance axis
and XLA partitions the whole interior-point ``while_loop`` SPMD, so each
chip advances its shard independently with no per-iteration cross-chip
sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class BatchedSolveResult:
    """Results of a batched solve (leading axis = instance)."""

    x_full: np.ndarray          # (B, n_full) unscaled full variable vectors
    objective: np.ndarray       # (B,)
    converged: np.ndarray       # (B,) bool
    iterations: np.ndarray      # (B,)
    kkt_error: np.ndarray       # (B,)
    solve_time: float = 0.0


def make_theta_batch(iteration, overrides: Dict) -> np.ndarray:
    """Build a (B, n_full) theta batch from variable-reference overrides.

    ``overrides`` maps *full-vector indices* (or ``("phase", i, "y", j,
    "node", k)``-style tuples resolved by :func:`resolve_theta_index`) to
    (B,)-shaped arrays.
    """
    sizes = {np.asarray(v).shape[0] for v in overrides.values()}
    if len(sizes) != 1:
        raise ValueError("All override arrays must share the batch size.")
    B = sizes.pop()
    theta = np.tile(iteration.theta_default, (B, 1))
    for key, values in overrides.items():
        idx = resolve_theta_index(iteration, key)
        theta[:, idx] = np.asarray(values)
    return theta


def resolve_theta_index(iteration, key) -> int:
    """Resolve an override key to an index of the full variable vector.

    Accepted keys: plain integers (direct indices), or tuples
    ``(phase_index, kind, var_index, node_index)`` with kind in
    ``{"y", "u", "q", "t"}`` (node_index ignored for q/t; for t,
    var_index 0 = t0, 1 = tF), or ``("s", i)``.
    """
    if isinstance(key, (int, np.integer)):
        return int(key)
    lay = iteration.layout
    if key[0] == "s":
        return lay.s_off + int(key[1])
    p, kind, var = key[0], key[1], int(key[2])
    pl = lay.phases[int(p)]
    if kind == "y":
        node = int(key[3])
        return pl.y_off + var * pl.N + (node % pl.N)
    if kind == "u":
        node = int(key[3])
        return pl.u_off + var * pl.N + (node % pl.N)
    if kind == "q":
        return pl.q_off + var
    if kind == "t":
        return pl.t_off + var
    raise KeyError(key)


def solve_batched(backend, overrides=None, batch_size: Optional[int] = None,
                  devices=None, theta_batch: Optional[np.ndarray] = None,
                  x0_batch: Optional[np.ndarray] = None,
                  options=None) -> BatchedSolveResult:
    """Solve a batch of perturbed instances of the current mesh iteration.

    Instances whose ``theta`` pins different values for fixed variables
    (initial conditions, parameters, endpoint targets) solve in one
    vmapped, device-sharded interior-point call.
    """
    import time

    import jax
    import jax.numpy as jnp

    iteration = backend.mesh_iterations[-1]
    if theta_batch is None:
        if overrides:
            theta_batch = make_theta_batch(iteration, overrides)
        else:
            B = batch_size or 1
            theta_batch = np.tile(iteration.theta_default, (B, 1))
    theta_batch = np.asarray(theta_batch)
    B = theta_batch.shape[0]
    if x0_batch is None:
        x0_batch = np.tile(iteration.xs_guess, (B, 1))

    if iteration._solver is None:
        iteration.build_solver(options)
    solver = iteration._solver

    batched = jax.jit(jax.vmap(solver))
    theta_j = jnp.asarray(theta_batch)
    x0_j = jnp.asarray(x0_batch)
    if devices is not None and len(devices) > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec
        mesh = Mesh(np.asarray(devices), ("batch",))
        sharding = NamedSharding(mesh, PartitionSpec("batch"))
        theta_j = jax.device_put(theta_j, sharding)
        x0_j = jax.device_put(x0_j, sharding)

    t0 = time.perf_counter()
    res = batched(x0_j, theta_j)
    res.x.block_until_ready()
    dt = time.perf_counter() - t0

    assemble = jax.jit(jax.vmap(iteration.assemble_full))
    x_full = np.asarray(assemble(res.x, theta_j))
    return BatchedSolveResult(
        x_full=x_full,
        objective=np.asarray(res.f) / iteration.w,
        converged=np.asarray(res.converged),
        iterations=np.asarray(res.iterations),
        kkt_error=np.asarray(res.kkt_error),
        solve_time=dt)
