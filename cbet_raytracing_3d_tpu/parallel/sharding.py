"""Multi-device execution: shard_map over a ray mesh axis + psum reduction.

Replaces the reference's multi-GPU story — static beam split across 2 GPUs
with fully replicated inputs and a host-CPU OpenMP sum of per-GPU deposition
grids (``main.cu:133-152,166-176,199-210``; ``multi_gpu.cpp``) — with an
on-device equivalent: the flat ray (slot) axis is sharded over a 1-D
``jax.sharding.Mesh``, the small inputs (node fields, tables) are replicated,
each device accumulates a local deposition grid, and the grids are combined
with ``jax.lax.psum`` (NCCL over NVLink on GPUs).  Slot-level sharding stays
load-balanced for any device count — unlike the reference's hard-coded
``nGPUs=2`` beam split (def.cuh:116).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Config
from ..models.raytracer import RayState, TraceContext, make_trace_fn

AXIS = "rays"


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def pad_rays(state: RayState, multiple: int) -> RayState:
    """Pad the slot axis to a multiple of ``multiple`` with dead rays
    (``n_devices * rays_per_tile`` keeps shards at tile boundaries).
    Host (NumPy) states stay on the host."""
    n = state.n
    pad = (-n) % multiple
    if pad == 0:
        return state
    xp = np if isinstance(state.uray, np.ndarray) else jnp

    def pad0(x, fill=0):
        return xp.pad(x, (0, pad), constant_values=fill)

    return RayState(
        frac=tuple(pad0(a) for a in state.frac),
        vel=tuple(pad0(a) for a in state.vel),
        kick=tuple(pad0(a) for a in state.kick),
        uray=pad0(state.uray),
        # avoid 0 <= stop_frac*0 edge cases in the termination rule
        uray_init=pad0(state.uray_init, fill=1),
        cell=tuple(pad0(a) for a in state.cell),
        alive=pad0(state.alive, fill=False),
    )


def put_state(state: RayState) -> RayState:
    """Transfer a host-built ray state to the default device (pure
    transfers — no compilations; see raytracer.prepare(host_state=True))."""
    return jax.tree_util.tree_map(jnp.asarray, state)


def make_sharded_trace_fn(cfg: Config, mesh: Mesh):
    """Jitted multi-device trace:
    ``(field4, state0) -> (edep, state, overflow)``.

    ``state0``'s slot axis must be divisible by the mesh size (see
    ``pad_rays``).  The deposition grid is psum-reduced across devices; the
    returned ``edep`` is replicated, the ray state stays sharded."""
    trace1 = make_trace_fn(cfg)

    def local_trace(field4, state0):
        edep, state, oflow = trace1(field4, state0)
        return (jax.lax.psum(edep, AXIS), state, jax.lax.psum(oflow, AXIS))

    # check_vma=False: the per-device edep accumulator starts as a replicated
    # zeros array and *becomes* device-varying via deposits from sharded ray
    # state; the varying-manual-axes checker can't express that transition
    # through the scan carry.
    sharded = jax.shard_map(
        local_trace,
        mesh=mesh,
        in_specs=(P(), P(AXIS)),
        out_specs=(P(), P(AXIS), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_segmented_trace_fn(cfg: Config, mesh: Mesh,
                                    rays_per_tile: int, dev_segments,
                                    track_final_state: bool = False):
    """Multi-device trace with per-device static tile compaction — the
    device-parallel form of ``raytracer.make_segmented_trace_fn``.

    ``dev_segments`` is a ``tileplan.DeviceSegments``: every device runs the
    same segment structure (same shapes), but its own tile ids — those ride
    in as *sharded arguments* (one (1, T_s) row per device inside
    shard_map), so one traced program serves all devices.  Deposition grids
    and the overflow counter are psum-reduced across devices.

    Returns ``fn(field4, state0) -> (edep, state, oflow)``; ``state0`` must
    be ordered device-major per ``dev_segments.tiles[0]`` (see
    ``device_major_state``).  ``track_final_state=True`` appends
    ``(uray_full, alive_full)`` — device-major full-length (state0.n,)
    arrays with every slot's final energy/liveness written back at segment
    boundaries (the sharded analog of
    ``raytracer.make_segmented_trace_fn(track_final_state=True)``), so
    ``trace_stats`` stays complete under compaction."""
    import dataclasses as _dc

    import jax.numpy as _jnp

    from ..models import raytracer as _rt

    rpt = rays_per_tile
    make_chunk_body, _, _, n_chunks = _rt._make_chunk_machinery(cfg)
    assert sum(len(c) for c in dev_segments.chunk_lengths) == n_chunks

    n_seg = len(dev_segments.chunk_lengths)
    # stacked per-device gather/valid arrays, sharded on the device axis
    pos_args = [_jnp.asarray(dev_segments.tiles[si]) for si in range(1, n_seg)]
    val_args = [_jnp.asarray(np.repeat(dev_segments.valid[si], rpt, axis=1))
                for si in range(1, n_seg)]
    valid0 = _jnp.asarray(np.repeat(dev_segments.valid[0], rpt, axis=1))
    widths = [t.shape[1] for t in dev_segments.tiles]

    if track_final_state:
        # per-segment slot origins in the device-local segment-0 slot
        # space; pad-duplicate rows write to index n0_local and are
        # dropped by the scatter (mode="drop")
        n0_local = widths[0] * rpt
        from ..models.tileplan import origin_slots
        origin_args = [
            _jnp.asarray(origin_slots(                        # (D, T_s*rpt)
                np.asarray(dev_segments.tiles_local[si]),
                dev_segments.valid[si], rpt, n0_local))
            for si in range(n_seg)]

    def local_trace(field4, state0, valid0_l, origins, *gathers):
        master = jnp.zeros(cfg.edep_shape, _rt.master_dtype(cfg))
        chunk_body = make_chunk_body(field4, state0.uray.dtype)
        # mask rays on dup-padded segment-0 tiles (balancing padding)
        state = _dc.replace(state0, alive=state0.alive & valid0_l[0])
        oflow = jnp.int32(0)
        if track_final_state:
            uray_full, alive_full = state0.uray, state0.alive

        def write_back(uray_full, alive_full, si):
            ix = origins[si][0]
            return (uray_full.at[ix].set(state.uray, mode="drop"),
                    alive_full.at[ix].set(state.alive, mode="drop"))

        for si in range(n_seg):
            if si > 0:
                if track_final_state:
                    uray_full, alive_full = write_back(
                        uray_full, alive_full, si - 1)
                pos = gathers[si - 1][0]          # (1, T_s) local shard
                val = gathers[si - 1][1][0]
                t_prev = widths[si - 1]

                def take_tiles(a, t_prev=t_prev, pos=pos):
                    return a.reshape(t_prev, rpt)[pos[0]].reshape(-1)

                state = jax.tree_util.tree_map(take_tiles, state)
                state = _dc.replace(state, alive=state.alive & val)
            steps = jnp.asarray(dev_segments.chunk_lengths[si], jnp.int32)
            (state, master, oflow), _ = jax.lax.scan(
                chunk_body, (state, master, oflow), steps)
        out = (jax.lax.psum(master, AXIS), state,
               jax.lax.psum(oflow, AXIS))
        if track_final_state:
            uray_full, alive_full = write_back(
                uray_full, alive_full, n_seg - 1)
            out = out + ((uray_full, alive_full),)
        return out

    gather_specs = tuple((P(AXIS), P(AXIS)) for _ in range(n_seg - 1))
    out_specs = (P(), P(AXIS), P())
    if track_final_state:
        out_specs = out_specs + ((P(AXIS), P(AXIS)),)
    sharded = jax.shard_map(
        local_trace, mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS),
                  (P(AXIS),) * n_seg if track_final_state else P())
                 + gather_specs,
        out_specs=out_specs,
        check_vma=False)
    fn = jax.jit(sharded)

    def run(field4, state0):
        gathers = tuple((pos_args[i], val_args[i])
                        for i in range(n_seg - 1))
        origins = tuple(origin_args) if track_final_state else 0
        return fn(field4, state0, valid0, origins, *gathers)

    return run


def device_major_state(state0: RayState, rays_per_tile: int,
                       dev_segments) -> RayState:
    """Order ``state0`` device-major per ``dev_segments.tiles[0]`` (tile ids
    in the space the plan was measured on, dup-padded per device) — the
    initial-state layout ``make_sharded_segmented_trace_fn`` expects."""
    from ..models.raytracer import select_rays

    rpt = rays_per_tile
    tiles0 = np.asarray(dev_segments.tiles[0]).reshape(-1)    # (D*T_0,)
    slots = (tiles0[:, None] * rpt + np.arange(rpt)[None, :]).reshape(-1)
    return select_rays(state0, slots)


def run_sharded(ctx: TraceContext, mesh: Mesh | None = None):
    """Convenience entry: pad, trace, return (edep np.f64, state)."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = math.prod(mesh.devices.shape)
    state0 = pad_rays(ctx.state0, n_dev * ctx.layout.rays_per_tile)
    fn = make_sharded_trace_fn(ctx.cfg, mesh)
    edep, state, oflow = fn(ctx.field4, state0)
    from ..models.raytracer import check_overflow
    check_overflow(int(jax.device_get(oflow)))
    return np.asarray(jax.device_get(edep), dtype=np.float64), state
