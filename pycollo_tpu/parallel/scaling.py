"""Scaling-efficiency harness for batched solves across a device mesh.

Measures solves/sec for the same per-device batch on 1 device vs all N
devices of a ``jax.sharding.Mesh`` (weak scaling — the regime of the
BASELINE target: >= 80% solves/s efficiency from 1 to N hosts).  The
batched interior-point solve is embarrassingly parallel across instances;
the only cross-device traffic is the result gather, so efficiency is
expected near 1.0.  On hardware with one device, run on the CPU
backend with ``xla_force_host_platform_device_count`` for a virtual mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class ScalingResult:
    n_devices: int
    per_device_batch: int
    single_device_solves_per_sec: float
    all_devices_solves_per_sec: float

    @property
    def efficiency(self) -> float:
        ideal = self.single_device_solves_per_sec * self.n_devices
        return self.all_devices_solves_per_sec / ideal


def measure_scaling_efficiency(iteration, per_device_batch: int = 32,
                               devices=None, n_rep: int = 3,
                               options=None) -> ScalingResult:
    """Weak-scaling measurement of batched solves over a device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if iteration._solver is None:
        iteration.build_solver(options)
    solver = iteration._solver
    batched = jax.jit(jax.vmap(solver))

    def run(dev_list, B):
        mesh = Mesh(np.asarray(dev_list), ("batch",))
        sharding = NamedSharding(mesh, P("batch"))
        x0 = jax.device_put(
            jnp.tile(jnp.asarray(iteration.xs_guess), (B, 1)), sharding)
        theta = jax.device_put(
            jnp.tile(jnp.asarray(iteration.theta_default), (B, 1)),
            sharding)
        res = batched(x0, theta)           # compile + warm-up
        res.x.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(n_rep):
            res = batched(x0, theta)
            res.x.block_until_ready()
        dt = (time.perf_counter() - t0) / n_rep
        return B / dt

    single = run(devices[:1], per_device_batch)
    full = run(devices, per_device_batch * n_dev)
    return ScalingResult(n_devices=n_dev,
                         per_device_batch=per_device_batch,
                         single_device_solves_per_sec=single,
                         all_devices_solves_per_sec=full)
