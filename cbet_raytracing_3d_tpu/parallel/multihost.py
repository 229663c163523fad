"""Multi-process execution: ``jax.distributed`` + the same shard_map/psum
story over a *global* device mesh.

The reference is strictly single-host — its whole "communication backend" is
in-process ``cudaMemcpy`` plus a host-CPU OpenMP sum of replicated grids
(``multi_gpu.cpp:3-59``, ``main.cu:199-210``).  SURVEY.md §5.8 names
``jax.distributed.initialize`` as the multi-host analog; this module makes
that path real rather than hypothetical:

- process-level initialization (explicit coordinator address, process
  count and id — nothing in the environment names a cluster),
- a global mesh over every process's devices,
- host-local -> global conversion for the sharded ray slot axis,
- a multi-process trace entry whose deposition grid is psum-reduced across
  all processes' devices and lands replicated (readable on every process).

On GPUs each process owns one card (``local_device_ids=[process_id]`` when
the processes share a host); ``jax.devices()`` then returns the global
device list and everything below — including the single-host entry points
in ``parallel.sharding`` — operates on global arrays unchanged.  The smoke
path (two CPU processes, gloo collectives over localhost TCP) is exercised
by ``scripts/smoke_multihost.py`` / ``tests/test_multihost.py``.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config
from ..models.raytracer import RayState, check_overflow
from .sharding import AXIS, make_mesh, make_sharded_trace_fn, pad_rays

__all__ = [
    "initialize_multihost", "global_mesh", "local_slot_slice",
    "state_to_global", "run_sharded_multihost",
]


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, *,
                         local_device_ids: list[int] | None = None,
                         cpu_collectives: str = "gloo") -> None:
    """Initialize multi-process JAX.  Call once, before any backend use.

    ``coordinator_address`` is ``host:port`` of process 0 (e.g.
    ``localhost:<free port>`` on one machine).  ``local_device_ids`` pins
    this process to its own cards (``[process_id]`` for one card per
    process on a shared host).  ``cpu_collectives``: implementation for
    cross-process CPU collectives ("gloo" over TCP); GPU processes use
    NCCL."""
    if cpu_collectives:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_mesh(devices=None) -> Mesh:
    """1-D mesh over the *global* device list (every process's devices)."""
    return make_mesh(jax.devices() if devices is None else devices)


def local_slot_slice(n_slots: int, mesh: Mesh) -> slice:
    """The contiguous slot range this process contributes to a
    ``P(AXIS)``-sharded state of ``n_slots`` total rows.

    ``n_slots`` must divide evenly over the global device count (use
    ``sharding.pad_rays`` first); JAX shards a 1-D axis contiguously in
    device order, and each process's addressable devices are a contiguous
    block of ``mesh.devices``, so the process's rows are
    ``[first_local_shard * per_dev, ...)``.
    """
    devs = list(mesh.devices.reshape(-1))
    n_dev = len(devs)
    if n_slots % n_dev:
        raise ValueError(f"n_slots={n_slots} not divisible by {n_dev} devices")
    per_dev = n_slots // n_dev
    local_ids = {d.id for d in jax.local_devices()}
    positions = [i for i, d in enumerate(devs) if d.id in local_ids]
    if positions and positions != list(range(positions[0],
                                             positions[0] + len(positions))):
        raise ValueError("this process's devices are not contiguous in the "
                         "mesh; order mesh devices process-major")
    if not positions:
        return slice(0, 0)
    return slice(positions[0] * per_dev, (positions[-1] + 1) * per_dev)


def state_to_global(state_local: RayState, n_slots: int,
                    mesh: Mesh) -> RayState:
    """Assemble a global ``P(AXIS)``-sharded RayState from this process's
    local rows (its ``local_slot_slice`` of the full slot axis).

    Every process must call this collectively with its own slice; the result
    is a global jax.Array tree usable by ``make_sharded_trace_fn`` under a
    multi-process runtime.
    """
    from jax.experimental import multihost_utils as mh

    def to_global(x):
        return mh.host_local_array_to_global_array(
            np.asarray(x), mesh, P(AXIS))

    return jax.tree_util.tree_map(to_global, state_local)


def replicate_to_global(x, mesh: Mesh):
    """Replicate identical host data onto every device of a global mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def run_sharded_multihost(cfg: Config, field4, state0_host: RayState,
                          rays_per_tile: int, mesh: Mesh | None = None):
    """Multi-process trace entry: every process passes the FULL host-built
    ``state0_host`` (deterministic, so identical across processes); each
    keeps only its ``local_slot_slice`` rows, the trace runs sharded over
    the global mesh, per-device grids psum-reduce across processes, and the
    replicated ``edep`` is returned as host float64 on every process.

    This is the multi-host form of ``sharding.run_sharded``; the reference's
    counterpart (host-summed replicated grids, ``main.cu:199-210``) cannot
    leave one machine.
    """
    if mesh is None:
        mesh = global_mesh()
    n_dev = math.prod(mesh.devices.shape)
    state0 = pad_rays(state0_host, n_dev * rays_per_tile)
    n_slots = state0.uray.shape[0]
    sl = local_slot_slice(n_slots, mesh)
    local = jax.tree_util.tree_map(lambda x: np.asarray(x)[sl], state0)
    state_g = state_to_global(local, n_slots, mesh)
    field_g = replicate_to_global(field4, mesh)

    fn = make_sharded_trace_fn(cfg, mesh)
    edep, state, oflow = fn(field_g, state_g)
    # replicated outputs: every process can read shard 0 of its own devices
    check_overflow(int(np.asarray(jax.device_get(
        oflow.addressable_data(0)))))
    return (np.asarray(jax.device_get(edep.addressable_data(0)),
                       dtype=np.float64), state)
