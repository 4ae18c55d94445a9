"""Multi-host (multi-process) batched solving over DCN.

New capability relative to the serial reference (SURVEY.md section 2
"absent" rows: no NCCL/MPI/Gloo anywhere in pycollo): batched OCP solves
scale across *hosts* with ``jax.distributed`` + a global
``jax.sharding.Mesh`` spanning every process's devices.  The instance
axis is sharded host-major, each host feeds its local shard
(``jax.make_array_from_process_local_data``), XLA partitions the whole
interior-point ``while_loop`` SPMD, and the only cross-host traffic is
the convergence-count ``psum``-style reduction and the result gather —
which is why the weak-scaling efficiency target (>= 80% from 1 to N
hosts, BASELINE.md) is attainable on DCN.

Usage (one call per process)::

    from pycollo_tpu.parallel import multihost
    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=N, process_id=i)
    out = multihost.solve_batched_global(iteration, per_host_batch=256)

The harness in ``tests/integration/test_multihost.py`` runs this on two
local processes over a virtual CPU mesh — the same code path a real
multi-host GPU cluster uses, minus the hardware.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_ids=None):
    """Bring up the distributed runtime (idempotent per process).

    Thin wrapper over ``jax.distributed.initialize`` so user code does
    not import jax before the platform env vars are set.
    """
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


@dataclass
class MultihostSolveResult:
    """Per-host view of a global batched solve."""

    local_objective: np.ndarray     # objectives of this host's shard
    local_converged: np.ndarray     # convergence flags of the shard
    global_converged: int           # total converged across hosts
    global_batch: int
    solve_time: float


def solve_batched_global(iteration, theta_local: Optional[np.ndarray] = None,
                         per_host_batch: int = 32, options=None,
                         n_rep: int = 1) -> MultihostSolveResult:
    """Solve a globally-sharded batch of perturbed instances.

    ``theta_local``: this host's (per_host_batch, n_full) block of the
    global theta batch (defaults to copies of ``theta_default``).  The
    global batch is the concatenation over process index.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if iteration._solver is None:
        iteration.build_solver(options)
    solver = iteration._solver

    if theta_local is None:
        theta_local = np.tile(iteration.theta_default, (per_host_batch, 1))
    B_local = theta_local.shape[0]
    B_global = B_local * jax.process_count()
    x0_local = np.tile(iteration.xs_guess, (B_local, 1))

    mesh = Mesh(np.asarray(jax.devices()), ("batch",))
    sharding = NamedSharding(mesh, P("batch"))
    theta_g = jax.make_array_from_process_local_data(
        sharding, np.asarray(theta_local), (B_global,
                                            theta_local.shape[1]))
    x0_g = jax.make_array_from_process_local_data(
        sharding, x0_local, (B_global, x0_local.shape[1]))

    @jax.jit
    def step(x0, theta):
        res = jax.vmap(solver)(x0, theta)
        return res.f, res.converged, jnp.sum(res.converged.astype(
            jnp.int32))

    # Untimed warm-up: compile (collective) happens outside the timed
    # region, otherwise the reported rate is dominated by one-time
    # compilation.
    fs, conv, n_conv = step(x0_g, theta_g)
    jax.block_until_ready(fs)
    t0 = time.perf_counter()
    for _ in range(max(n_rep, 1)):
        fs, conv, n_conv = step(x0_g, theta_g)
        jax.block_until_ready(fs)
    dt = (time.perf_counter() - t0) / max(n_rep, 1)

    # Per-host shard extraction (addressable slice of the global array).
    local_f = np.concatenate(
        [np.asarray(s.data).reshape(-1)
         for s in fs.addressable_shards]) / iteration.w
    local_c = np.concatenate(
        [np.asarray(s.data).reshape(-1)
         for s in conv.addressable_shards])
    return MultihostSolveResult(local_objective=local_f,
                                local_converged=local_c,
                                global_converged=int(n_conv),
                                global_batch=B_global,
                                solve_time=dt)


def measure_multihost_scaling(iteration, per_host_batch: int = 32,
                              options=None, n_rep: int = 3) -> Dict:
    """Weak-scaling measurement: solves/s on this host's devices alone
    vs the full multi-host mesh (>= 80% target, BASELINE.md).

    Returns a dict with both rates and the efficiency; every process
    must call this collectively (it runs two sharded solves).
    """
    import jax

    # Full-mesh rate (collective).
    full = solve_batched_global(iteration, per_host_batch=per_host_batch,
                                options=options, n_rep=n_rep)
    full_rate = full.global_batch / full.solve_time

    # Single-host-equivalent rate: local devices only, local batch.
    from .scaling import measure_scaling_efficiency
    local = measure_scaling_efficiency(
        iteration, per_device_batch=max(1, per_host_batch
                                        // jax.local_device_count()),
        devices=jax.local_devices(), n_rep=n_rep, options=options)
    single_rate = local.all_devices_solves_per_sec

    ideal = single_rate * jax.process_count()
    return dict(processes=jax.process_count(),
                global_devices=jax.device_count(),
                per_host_batch=per_host_batch,
                single_host_solves_per_sec=single_rate,
                multi_host_solves_per_sec=full_rate,
                efficiency=full_rate / ideal if ideal else float("nan"))
