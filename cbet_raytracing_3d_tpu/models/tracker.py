"""Ray trajectory + cell-crossing diagnostics.

The reference scaffolds these as dormant compile-time hooks with no
implementation in the snapshot (``RAY_TRACKER_DIAGNOSTICS`` /
``INTERSECTION_DIAGNOSTICS``, def.cuh:26-27, both 0 and unreferenced); here
they are a live runtime capability: trace a selected subset of rays through
the production step physics (``make_deferred_step_fn`` — the exact
launch_ray_XZ.cu:207-357 transcription) recording the full per-step history
(cell, physical position, energy), and extract per-ray cell-crossing lists
bounded by the reference's CBET bookkeeping contract
(``ncrossings = 3*nx`` crossings/ray, def.cuh:96).

Recording semantics match the oracle's ``trace_ray(record_path=True)``
exactly: one entry per executed step, post-update, including the terminating
step (oracle.py:249-256 appends then breaks).  Pupil-rejected rays
(launch_ray_XZ.cu:114,181-182) record zero steps.

Tracked-ray counts are diagnostic-scale (tens to thousands), so the scan
over the (K,) batch costs little next to a full trace, and the whole
history (nt, K) stays small enough to materialize.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from .raytracer import (RayState, TraceContext, make_deferred_step_fn,
                        select_rays)


@dataclasses.dataclass(frozen=True)
class RayTrajectories:
    """Per-step history of K tracked rays over nt steps.

    ``recorded[t, i]`` marks entries that correspond to an executed step of
    ray i (the ray was alive entering step t); history values outside that
    mask are frozen at the ray's terminal state and should be ignored."""

    beams: np.ndarray      # (K,) int32 beam index of each tracked ray
    ray_ids: np.ndarray    # (K,) int32 reference thread id (pre_raynum)
    launched: np.ndarray   # (K,) bool — False: pupil-rejected, no steps
    steps: np.ndarray      # (K,) int32 number of executed (recorded) steps
    uray_init: np.ndarray  # (K,) float launch energy (the 5% stop scale)
    cell: np.ndarray       # (nt, K, 3) int32 cell index after each step
    pos: np.ndarray        # (nt, K, 3) float physical position [cm]
    uray: np.ndarray       # (nt, K) float ray energy after each step
    recorded: np.ndarray   # (nt, K) bool — see class docstring

    @property
    def n(self) -> int:
        return self.beams.shape[0]

    def path(self, i: int) -> list[tuple]:
        """Ray i's history in the oracle's path-tuple format
        ``(cx, cy, cz, x, y, z, uray)`` (oracle.py:250)."""
        return [(int(self.cell[t, i, 0]), int(self.cell[t, i, 1]),
                 int(self.cell[t, i, 2]), float(self.pos[t, i, 0]),
                 float(self.pos[t, i, 1]), float(self.pos[t, i, 2]),
                 float(self.uray[t, i]))
                for t in np.nonzero(self.recorded[:, i])[0]]

    def crossings(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Ray i's cell-crossing list: ``(step_idx, cells)`` where ``cells``
        is the (C, 3) sequence of distinct cells entered (the launch cell at
        step index -1 convention is NOT used: entry 0 is the cell after the
        first step; a crossing is any step whose post-step cell differs from
        the previous step's).  Bounded by the reference capacity
        ``ncrossings = 3*nx`` (def.cuh:96) for any in-box trajectory."""
        m = self.recorded[:, i]
        cells = self.cell[m, i, :]
        if cells.shape[0] == 0:
            return (np.zeros((0,), np.int64), np.zeros((0, 3), np.int32))
        changed = np.ones((cells.shape[0],), bool)
        changed[1:] = (cells[1:] != cells[:-1]).any(axis=1)
        steps = np.nonzero(m)[0][changed]
        return steps, cells[changed]

    def crossing_counts(self) -> np.ndarray:
        """(K,) number of distinct-cell entries per ray (INTERSECTION
        diagnostics); compare against ``cfg.ncrossings``."""
        return np.array([self.crossings(i)[0].shape[0]
                         for i in range(self.n)])

    def save_npz(self, path: str) -> None:
        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)})

    @staticmethod
    def load_npz(path: str) -> "RayTrajectories":
        with np.load(path) as z:
            return RayTrajectories(**{f.name: z[f.name]
                                      for f in dataclasses.fields(
                                          RayTrajectories)})


def make_track_fn(cfg: Config):
    """Jittable ``(field4, state0) -> (final_state, history)`` where
    ``history = (cell (nt,K,3), pos (nt,K,3), uray (nt,K), recorded (nt,K))``
    — positions in physical cm, recording per the module contract."""
    step = make_deferred_step_fn(cfg)
    d = (cfg.dx, cfg.dy, cfg.dz)
    origin = (cfg.xmin, cfg.ymin, cfg.zmin)

    def track(field4, state0: RayState):
        dtype = state0.uray.dtype

        def body(state, _):
            entry_alive = state.alive
            new_state, _deposit = step(state, field4)
            cell = jnp.stack(new_state.cell, axis=-1)            # (K, 3)
            pos = jnp.stack(
                [(new_state.cell[ax].astype(dtype) + new_state.frac[ax])
                 * d[ax] + origin[ax] for ax in range(3)], axis=-1)
            return new_state, (cell, pos, new_state.uray, entry_alive)

        return jax.lax.scan(body, state0, None, length=cfg.nt)

    return track


def track_rays(cfg: Config, beams, ray_ids,
               ctx: TraceContext | None = None,
               prof=None, beam_norm=None) -> RayTrajectories:
    """Trace the (beam, pre_raynum) pairs with full per-step recording.

    ``beams`` / ``ray_ids`` are parallel sequences (reference thread ids,
    launch_ray_XZ.cu:123-134).  Pass any existing ``ctx`` to reuse a
    scene: slots are computed in CLOSED FORM (raytracer.slots_of_rays —
    no O(nbeams*nrays) map, seconds even at config-4 scale), and compact
    (prepare_device) contexts are supported by mapping the global tile id
    through the deterministic traced tile order (live_tile_ids).  Rays
    whose tile is absent from a compact layout are pupil-dead tiles —
    they record zero steps, same as any unlaunched ray."""
    beams = np.atleast_1d(np.asarray(beams, np.int32))
    ray_ids = np.atleast_1d(np.asarray(ray_ids, np.int32))
    if beams.shape != ray_ids.shape:
        raise ValueError("beams and ray_ids must be parallel sequences")
    if (beams.min() < 0 or beams.max() >= cfg.nbeams
            or ray_ids.min() < 0 or ray_ids.max() >= cfg.nrays):
        raise ValueError("beam or ray id out of range")
    if ctx is None:
        # the on-device init: O(grid + nrays) host work + one jit (runs on
        # CPU too) — the full host prepare costs tens of seconds at OMEGA
        # scale and minutes at config 4 just to track a handful of rays
        from .raytracer import prepare_device
        ctx = prepare_device(cfg, prof=prof, beam_norm=beam_norm)
    elif ctx.cfg != cfg:
        # the track fn's flat field4 indices and the slot formula are built
        # from cfg; a context prepared under a different config would be
        # read with the wrong strides — jnp.take clamps under jit, so the
        # mismatch would record silently-wrong trajectories, not crash
        raise ValueError(
            "track_rays: cfg does not match ctx.cfg — pass the context's "
            "own config or rebuild the context for this one")
    from .raytracer import live_tile_ids, slots_of_rays
    layout = ctx.layout
    rpt = layout.rays_per_tile
    gtile, rit = slots_of_rays(cfg, beams, ray_ids)
    found = None
    if ctx.compact:
        # traced position of each global tile in the compact layout
        ids = live_tile_ids(cfg, layout)
        pos_of = np.full(cfg.nbeams * layout.tiles_per_beam, -1, np.int64)
        pos_of[ids] = np.arange(len(ids), dtype=np.int64)
        pos = pos_of[gtile]
        found = pos >= 0
        slots = np.where(found, pos, 0) * rpt + rit
    else:
        slots = gtile * rpt + rit

    k = beams.shape[0]
    sel = select_rays(ctx.state0, slots)
    if found is not None and not found.all():
        xp = np if isinstance(sel.uray, np.ndarray) else jnp
        m = xp.asarray(found)
        sel = dataclasses.replace(
            sel, alive=sel.alive & m,
            uray=xp.where(m, sel.uray, xp.zeros_like(sel.uray)),
            uray_init=xp.where(m, sel.uray_init,
                               xp.ones_like(sel.uray_init)))
    state0 = sel
    if isinstance(state0.uray, np.ndarray):     # host-state context
        state0 = jax.tree.map(jnp.asarray, state0)
    field4 = jnp.asarray(ctx.field4)

    track = jax.jit(make_track_fn(cfg))
    _final, (cell, pos, uray, recorded) = track(field4, state0)

    cell = np.asarray(cell)
    pos = np.asarray(pos)
    uray = np.asarray(uray)
    recorded = np.asarray(recorded)
    launched = recorded[0] if cfg.nt > 0 else np.zeros((k,), bool)
    return RayTrajectories(
        beams=beams, ray_ids=ray_ids, launched=np.asarray(launched),
        steps=recorded.sum(axis=0).astype(np.int32),
        uray_init=np.asarray(state0.uray_init),
        cell=cell, pos=pos, uray=uray, recorded=recorded)
