"""The ray-trace integrator.

Replaces the reference's one-CUDA-thread-per-ray time loop
(``launch_ray_XZ.cu:117-359``) with a batched functional design:

* all rays of all beams form one flat batch axis, ordered by *launch tile*
  (a patch of adjacent launch-lattice sites) so that consecutive rays stay
  spatially coherent through the whole trace (deposits of neighbouring
  rays land on neighbouring nodes),
* the 400-step time loop is a ``lax.scan`` in chunks,
* the 8 per-step radial interpolations become ONE interleaved row-gather
  from precomputed node fields (see ``fields.py``; the gradient kick is
  carried one step in the ray state so absorption + next-step kick share the
  same gather),
* deposition is one vectorized XLA scatter-add of the 8 trilinear corners
  per ray-step — on a GPU XLA lowers it to atomic adds, the reference's own
  design (``atomicAdd``, launch_ray_XZ.cu:319-348),
* early ray termination (the CUDA ``break``, launch_ray_XZ.cu:351-356)
  becomes an ``alive`` mask with frozen state.

Layout rule: every per-ray array is **1-D** (structure of arrays), so each
step's elementwise work fuses into coalesced 1-D loops.

Numerics: positions are carried *cell-relative* in grid units
(``cell + frac`` with ``frac = (pos - min)/d - cell``) so float32 rounding is
~1e-7 of a cell per step instead of ~1e-5 when carrying absolute coordinates;
per-step deposits accumulate into a float32 grid for ``chunk_steps`` steps,
then promote into a float64 master grid, bounding summation error far below
the 1e-4 accuracy bar (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as k
from ..beams import (RayInit, init_rays, lattice_xy, load_beam_norms,
                     power_table)
from ..config import Config
from ..fields import Fields, build_fields
from ..profiles import RadialProfiles, load_profiles

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RayState:
    """Per-ray integrator state: tuples of per-axis 1-D arrays, shape (N,).

    Positions are stored cell-relative (``cell`` + ``frac``) so float32
    rounding stays at the scale of one cell rather than of the whole grid."""

    frac: tuple     # (fx, fy, fz) position relative to the cell node, grid units
    vel: tuple      # (vx, vy, vz) displacement per step, grid units
    kick: tuple     # (kx, ky, kz) gradient kick at the current cell — carried
                    # from the previous step's single row-gather (see step fn)
    uray: jnp.ndarray       # (N,) ray energy
    uray_init: jnp.ndarray  # (N,) launch energy (for the 5% stop rule)
    cell: tuple     # (cx, cy, cz) int32 current cell
    alive: jnp.ndarray      # (N,) bool — still stepping

    @property
    def n(self) -> int:
        return self.uray.shape[0]


def initial_cell(cfg: Config, t: np.ndarray) -> np.ndarray:
    """Closed form of the reference's linear first-match cell scan
    (launch_ray_XZ.cu:162-183): the smallest node index within
    ``0.5001`` cells of the position; 0 if none matches.

    Works per axis on contiguous columns — (N, 3) float64 temporaries cost
    whole seconds at config-4 scale (64M rays) on a single host core."""
    nvec = (cfg.nx, cfg.ny, cfg.nz)
    tol = cfg.cell_tol
    out = np.zeros(t.shape, np.int32)
    for ax in range(t.shape[1]):
        ta = np.ascontiguousarray(t[:, ax])
        # first integer in [ta - tol, ta + tol] is ceil(ta - tol); the +1
        # candidate covers float rounding where ceil lands one below
        c0 = np.ceil(ta - tol).astype(np.int32)
        oa = out[:, ax]
        for cand in (c0 + 1, c0):       # later write (c0) wins: first match
            ok = (cand >= 0) & (cand <= nvec[ax] - 1)
            ok &= np.abs(cand - ta) <= tol
            np.copyto(oa, cand, where=ok)
    return out


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """Tile-major ray ordering (see module docstring).

    ``slot_of[beam, pre_raynum]`` maps a reference thread id to its slot in
    the flat ray axis; slots not covered by any ray are permanent dead
    padding (~6% of slots)."""

    rays_per_tile: int
    tiles_per_beam: int
    n_slots: int
    slot_of: np.ndarray       # (nbeams, nrays) int64


def build_tile_layout(cfg: Config, with_slots: bool = True) -> TileLayout:
    """``with_slots=False`` skips the O(nbeams*nrays) ``slot_of`` map —
    only the host prepare needs it (7.7 s at config-4 scale); the on-device
    init path (prepare_device) uses just the scalar layout facts."""
    rpz = cfg.rays_per_zone
    zones = cfg.zones_spanned
    tz = cfg.tile_zones
    side = tz * rpz                       # rays per tile edge (16)
    rays_per_tile = side * side           # 256
    ntiles_axis = -(-zones // tz)         # ceil
    tiles_per_beam = ntiles_axis * ntiles_axis
    n_slots = cfg.nbeams * tiles_per_beam * rays_per_tile
    if not with_slots:
        return TileLayout(rays_per_tile=rays_per_tile,
                          tiles_per_beam=tiles_per_beam,
                          n_slots=n_slots, slot_of=None)

    kk = np.arange(cfg.nrays, dtype=np.int64)
    b1, b2 = kk // (rpz * rpz), kk % (rpz * rpz)
    zy, zx = b1 // zones, b1 % zones
    ry2, rx2 = b2 // rpz, b2 % rpz
    tx, ty = zx // tz, zy // tz
    lx = (zx % tz) * rpz + rx2
    ly = (zy % tz) * rpz + ry2
    tile = ty * ntiles_axis + tx
    slot_in_beam = tile * rays_per_tile + ly * side + lx
    slot_of = (np.arange(cfg.nbeams, dtype=np.int64)[:, None]
               * tiles_per_beam * rays_per_tile + slot_in_beam[None, :])
    n_slots = cfg.nbeams * tiles_per_beam * rays_per_tile
    return TileLayout(rays_per_tile=rays_per_tile, tiles_per_beam=tiles_per_beam,
                      n_slots=n_slots, slot_of=slot_of)


def slots_of_rays(cfg: Config, beams, ray_ids):
    """Closed-form tile-layout coordinates for (beam, pre_raynum) pairs:
    returns ``(gtile, rit)`` — the global tile id and the ray's index
    within the tile — the SAME formula :func:`build_tile_layout`
    vectorizes over all rays, evaluated only at the requested ids
    (O(len(ids)) instead of the O(nbeams*nrays) ``slot_of`` map).

    Full-layout slot = ``gtile * rays_per_tile + rit`` (identical to
    ``slot_of[beam, ray_id]``, tested); compact (prepare_device) layouts
    map ``gtile`` through the traced tile order (:func:`live_tile_ids`)
    first."""
    rpz = cfg.rays_per_zone
    zones = cfg.zones_spanned
    tz = cfg.tile_zones
    side = tz * rpz
    ntiles_axis = -(-zones // tz)
    tiles_per_beam = build_tile_layout(cfg, with_slots=False).tiles_per_beam
    kk = np.asarray(ray_ids, np.int64)
    b1, b2 = kk // (rpz * rpz), kk % (rpz * rpz)
    zy, zx = b1 // zones, b1 % zones
    ry2, rx2 = b2 // rpz, b2 % rpz
    tx, ty = zx // tz, zy // tz
    lx = (zx % tz) * rpz + rx2
    ly = (zy % tz) * rpz + ry2
    tile = ty * ntiles_axis + tx
    gtile = np.asarray(beams, np.int64) * tiles_per_beam + tile
    return gtile, ly * side + lx


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Everything needed to run a trace: static config + device-ready arrays."""

    cfg: Config
    prof: RadialProfiles
    beam_norm: np.ndarray        # (nbeams, 3) float64
    fields: Fields               # float64 node fields (cache-loaded contexts
                                 # carry only .eden — all downstream needs)
    rays: RayInit | None         # float64 launch state (nbeams, nrays, ...);
                                 # None when loaded from the prepare cache
    layout: TileLayout
    field4: jnp.ndarray          # (P, 4) interleaved kick_x/y/z + absorb fields
                                 # (one 16-byte row per gathered node)
    state0: RayState             # tile-ordered (n_slots,) initial state
    beam_id: np.ndarray          # (n_slots,) int32 beam of each slot (-1 padding)
    live_slots: np.ndarray       # slots of tiles with >=1 launched ray (~83%);
                                 # pupil-dead/padding tiles never contribute
    compact: bool = False        # True: state0 is ALREADY the live-tile
                                 # compacted traced state (prepare_device) —
                                 # no further selection needed


PREP_CACHE_VERSION = 1


def _prep_fingerprint(cfg: Config, prof: RadialProfiles,
                      beam_norm: np.ndarray) -> str:
    """Config + scene-data + format fingerprint for the prepare cache."""
    import hashlib

    from ..utils.checkpoint import config_fingerprint
    h = hashlib.sha256(config_fingerprint(cfg).encode())
    h.update(str(PREP_CACHE_VERSION).encode())
    for a in (prof.r, prof.ne, prof.te, beam_norm):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _state_from_mats(cfg: Config, fmat, imat, mask_slots,
                     host_state: bool) -> RayState:
    # upload per row from host: plain transfers, no per-row slicing
    # programs to compile
    if host_state:
        def dev(a):
            return np.ascontiguousarray(a)
    else:
        dev = jnp.asarray
    f_dev = [dev(fmat[i]) for i in range(11)]
    i_dev = [dev(imat[i]) for i in range(3)]
    return RayState(
        frac=(f_dev[0], f_dev[1], f_dev[2]),
        vel=(f_dev[3], f_dev[4], f_dev[5]),
        kick=(f_dev[6], f_dev[7], f_dev[8]),
        uray=f_dev[9],
        uray_init=f_dev[10],
        cell=(i_dev[0], i_dev[1], i_dev[2]),
        alive=dev(mask_slots),
    )


def _live_slots_of(mask_slots: np.ndarray, rpt: int) -> np.ndarray:
    tile_live = mask_slots.reshape(-1, rpt).any(axis=1)
    return (np.nonzero(tile_live)[0][:, None] * rpt
            + np.arange(rpt)[None, :]).reshape(-1)


def prepare(cfg: Config, prof: RadialProfiles | None = None,
            beam_norm: np.ndarray | None = None,
            host_state: bool = False,
            cache_dir: str | None = None) -> TraceContext:
    """Host-side setup ("Init" phase): profiles, fields, rays, initial state.

    ``host_state=True`` leaves the ray state (and field table) as NumPy
    arrays: callers then subset/pad on the host and ``device_put`` once —
    pure transfers, no per-op compilations.

    ``cache_dir`` caches the heavy prepare products (state matrices, field
    table, density field) on disk keyed by a config+scene fingerprint —
    warm Init then reduces to a file read plus transfers (the reference's
    Init is a few buffer uploads, main.cu:131-152).  The cached context
    carries ``rays=None`` and a ``fields`` with only ``eden`` populated
    (everything downstream needs — CBET's gain prefactor)."""
    if prof is None:
        prof = load_profiles(nr=cfg.nr)
    if beam_norm is None:
        beam_norm = load_beam_norms(nbeams=cfg.nbeams)

    cache_path = None
    if cache_dir is not None:
        import os
        fp = _prep_fingerprint(cfg, prof, beam_norm)
        cache_path = os.path.join(cache_dir, f"prepare_{fp}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                fmat, imat = z["fmat"], z["imat"]
                mask_slots, beam_id = z["mask_slots"], z["beam_id"]
                field4_np, eden = z["field4"], z["eden"]
            # the cached path needs only the scalar layout facts — the
            # O(nbeams*nrays) slot_of map is what the cache exists to skip
            layout = build_tile_layout(cfg, with_slots=False)
            dtype = jnp.dtype(cfg.dtype)
            from .. import fields as _fields_mod
            fields = _fields_mod.CachedFields(eden)
            field4 = (field4_np if host_state
                      else jnp.asarray(field4_np, dtype))
            state0 = _state_from_mats(cfg, fmat, imat, mask_slots, host_state)
            return TraceContext(
                cfg=cfg, prof=prof, beam_norm=beam_norm, fields=fields,
                rays=None, layout=layout, field4=field4, state0=state0,
                beam_id=beam_id,
                live_slots=_live_slots_of(mask_slots, layout.rays_per_tile))

    fields = build_fields(cfg, prof)
    pow_r = power_table(cfg)
    rays = init_rays(cfg, beam_norm, pow_r)
    layout = build_tile_layout(cfg)

    dtype = jnp.dtype(cfg.dtype)
    d = np.array([cfg.dx, cfg.dy, cfg.dz])
    origin = np.array([cfg.xmin, cfg.ymin, cfg.zmin])

    # hot fields interleaved as (P, 4) rows [kick_x, kick_y, kick_z, absorb]
    # so the per-step lookup is ONE row-gather instead of four
    kick = fields.fgrad * cfg.dt / d          # (nx,ny,nz,3) grid units/step
    f4 = np.concatenate([kick.reshape(-1, 3),
                         fields.absorb.reshape(-1, 1)], axis=1)
    field4 = f4.astype(dtype) if host_state else jnp.asarray(f4, dtype)

    # --- initial ray state (float64 on host, cast once) ---
    pos = rays.pos.reshape(-1, 3)                     # (nbeams*nrays, 3) cm
    t0 = (pos - origin) / d                           # grid units
    cell0 = initial_cell(cfg, t0)

    # dispersion relation at the launch cell node (launch_ray_XZ.cu:186-204)
    flat0 = (cell0[:, 0] * cfg.ny + cell0[:, 1]) * cfg.nz + cell0[:, 2]
    wsq = fields.wsq_term.reshape(-1)[flat0]
    w = np.sqrt(np.maximum(k.OMEGA ** 2 - wsq, 0.0)) / k.C_CMS
    bn = beam_norm / np.linalg.norm(beam_norm, axis=1, keepdims=True)
    ray_beam = np.repeat(np.arange(cfg.nbeams, dtype=np.int32), cfg.nrays)
    v = -(k.C_CMS ** 2) * bn[ray_beam] * (w / k.OMEGA)[:, None]  # cm/s
    vel0 = v * cfg.dt / d                                        # grid units/step

    # scatter ray data into tile-ordered slots; uncovered slots stay dead.
    # One grouped fancy-index pass per dtype and one grouped upload instead
    # of 15 — the per-array version cost minutes at config-4 scale (64M
    # rays); casting to the compute dtype BEFORE the scatter halves the
    # host memory traffic again.
    slots = layout.slot_of.reshape(-1)
    ns = layout.n_slots
    np_dtype = np.dtype(cfg.dtype)

    frac0 = t0 - cell0
    kick0 = f4[flat0, :3]        # gradient kick at the launch cell (step 0)
    uray_flat = rays.uray.reshape(-1)
    fmat = np.zeros((11, ns), np_dtype)
    fmat[10] = 1.0     # padding slots: uray_init=1 keeps the 5% rule defined
    # per-row contiguous cast + scatter: transposing/concatenating the (N, 3)
    # float64 sources first costs ~10 s at OMEGA scale (strided f64 copies)
    for i in range(3):
        fmat[i, slots] = np.ascontiguousarray(frac0[:, i]).astype(np_dtype)
        fmat[3 + i, slots] = np.ascontiguousarray(vel0[:, i]).astype(np_dtype)
        fmat[6 + i, slots] = np.ascontiguousarray(kick0[:, i]).astype(np_dtype)
    fmat[9, slots] = uray_flat.astype(np_dtype)
    fmat[10, slots] = fmat[9, slots]
    imat = np.zeros((3, ns), np.int32)
    for i in range(3):
        imat[i, slots] = cell0[:, i]
    mask_slots = np.zeros((ns,), bool)
    mask_slots[slots] = rays.mask.reshape(-1)

    beam_id = np.full((ns,), -1, np.int32)
    beam_id[slots] = ray_beam

    if cache_path is not None:
        import os
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache_path + f".tmp{os.getpid()}.npz"
        field4_np = (field4 if isinstance(field4, np.ndarray)
                     else f4.astype(dtype))
        np.savez(tmp, fmat=fmat, imat=imat, mask_slots=mask_slots,
                 beam_id=beam_id, field4=field4_np, eden=fields.eden)
        os.replace(tmp, cache_path)

    state0 = _state_from_mats(cfg, fmat, imat, mask_slots, host_state)

    # tiles with no launched ray (pupil-rejected or layout padding, ~17% on
    # the reference scene) are statically dead: the fast paths trace only
    # live-tile slots (tile granularity preserves the kernel contract)
    live_slots = _live_slots_of(mask_slots, layout.rays_per_tile)

    return TraceContext(cfg=cfg, prof=prof, beam_norm=beam_norm, fields=fields,
                        rays=rays, layout=layout, field4=field4,
                        state0=state0, beam_id=beam_id, live_slots=live_slots)


_DEVICE_INIT_CACHE: dict = {}
# LRU-bounded like cbet._SOLVER_CACHE: each entry pins a compiled init
# executable; a config-sweeping process would otherwise grow it forever
_DEVICE_INIT_CACHE_MAX = 4


def make_device_init(cfg: Config, layout: TileLayout):
    """Jitted on-device ray initialization — the analog of the reference's
    GPU-side ``init()`` (launch_ray_XZ.cu:65-115; our host-NumPy prepare is
    the deviation, kept for exact-f64 parity tests).

    Returns ``fn(field4, wsq_flat, beam_tab, pow_r, tile_ids) -> RayState``
    where ``tile_ids`` (T,) int32 are global tile ids in traced order (live
    tiles) and the output state covers ``T * rays_per_tile`` slots.  Only KB-scale
    arrays cross the host->device link (the big per-ray state is born on
    device), which cuts Init at config-4 scale from minutes of single-core
    NumPy + GB-scale uploads to one jit call.

    ``beam_tab`` is (nbeams, 7) float: [c1, s1, c2, s2, bnx, bny, bnz]
    (rotation trig + unit beam normal, precomputed on host — tiny).

    The launch arithmetic runs in float64 and the state is rounded once to
    ``cfg.dtype``, like the host prepare: call ``fn`` with x64 enabled and
    float64 tables (prepare_device does).  In float32, the positions
    (grid units up to ~nx) lose ~1e-6 cells before ``frac`` is formed,
    which doubles a float32 trace's distance from the float64 trace.

    The jitted wrapper is cached per (cfg, layout): a fresh ``jax.jit``
    object gets a fresh trace+compile, which would make the *second*
    (steady-state) ``prepare_device`` as slow as the first."""
    key = (cfg, layout.rays_per_tile, layout.tiles_per_beam)
    hit = _DEVICE_INIT_CACHE.pop(key, None)
    if hit is not None:
        _DEVICE_INIT_CACHE[key] = hit      # refresh LRU recency
        return hit
    rpz = cfg.rays_per_zone
    zones = cfg.zones_spanned
    tz = cfg.tile_zones
    side = tz * rpz
    rpt = layout.rays_per_tile
    ntiles_axis = -(-zones // tz)
    tpb_real = ntiles_axis * ntiles_axis
    pstep = cfg.pow_table_max / (cfg.pow_table_len - 1)
    d = (cfg.dx, cfg.dy, cfg.dz)
    origin = (cfg.xmin, cfg.ymin, cfg.zmin)
    nvec = (cfg.nx, cfg.ny, cfg.nz)
    tol = cfg.cell_tol

    from ..ops.interp import uniform_interp

    def _initial_cell(t, n):
        c0 = jnp.ceil(t - tol).astype(jnp.int32)
        out = jnp.zeros_like(c0)
        for cand in (c0 + 1, c0):     # later write (c0) wins: first match
            ok = ((cand >= 0) & (cand <= n - 1)
                  & (jnp.abs(cand.astype(t.dtype) - t) <= tol))
            out = jnp.where(ok, cand, out)
        return out

    out_dtype = jnp.dtype(cfg.dtype)

    def init(field4, wsq_flat, beam_tab, pow_r, tile_ids):
        dtype = beam_tab.dtype                       # launch arithmetic
        T = tile_ids.shape[0]
        s = jnp.arange(T * rpt, dtype=jnp.int32)
        ti = s // rpt                                # index into tile_ids
        rit = s % rpt
        gtile = jnp.take(tile_ids, ti)
        beam = gtile // layout.tiles_per_beam
        tile = gtile % layout.tiles_per_beam
        ty, tx = tile // ntiles_axis, tile % ntiles_axis
        ly, lx = rit // side, rit % side
        zy = ty * tz + ly // rpz
        zx = tx * tz + lx // rpz
        ry2, rx2 = ly % rpz, lx % rpz
        in_lat = (tile < tpb_real) & (zx < zones) & (zy < zones)
        rx = zx * rpz + rx2
        ry = zy * rpz + ry2

        # launch lattice in the focal plane (launch_ray_XZ.cu:76-97);
        # ONE shared formula definition (beams.lattice_xy) keeps the host
        # init, device init, and live-tile selection in sync
        x0, y0 = lattice_xy(cfg, rx.astype(dtype), ry.astype(dtype))
        ref = jnp.sqrt(x0 * x0 + y0 * y0)
        z0 = jnp.asarray(cfg.focal_length - cfg.dz / 2, dtype)
        uray = cfg.uray_mult * uniform_interp(pow_r, 0.0, pstep, ref)
        mask = in_lat & (ref <= cfg.beam_max_x)
        if cfg.parity == "reference":
            kk = ((zy * zones + zx) * (rpz * rpz) + ry2 * rpz + rx2)
            mask &= kk < cfg.traced_rays_per_beam

        # per-beam Euler rotations (launch_ray_XZ.cu:99-111); seven 1-D
        # gathers keep the per-ray arrays structure-of-arrays
        bcol = [jnp.take(beam_tab[:, i], beam) for i in range(7)]
        c1, s1, c2, s2 = bcol[0], bcol[1], bcol[2], bcol[3]
        xa = x0 * c1 + z0 * s1
        za = z0 * c1 - x0 * s1
        xb = xa * c2 - y0 * s2
        yb = y0 * c2 + xa * s2

        # grid coordinates, initial cell, dispersion velocity
        cell, frac, flat = [], [], None
        pos = (xb, yb, za)
        for ax in range(3):
            t = (pos[ax] - origin[ax]) / d[ax]
            c = _initial_cell(t, nvec[ax])
            cell.append(c)
            frac.append(t - c.astype(dtype))
        flat = (cell[0] * cfg.ny + cell[1]) * cfg.nz + cell[2]
        wsq = jnp.take(wsq_flat, flat)
        w = jnp.sqrt(jnp.maximum(k.OMEGA ** 2 - wsq, 0.0)) / k.C_CMS
        vel = tuple(
            (-(k.C_CMS ** 2) * bcol[4 + ax] * (w / k.OMEGA))
            * (cfg.dt / d[ax]) for ax in range(3))
        # three 1-D column gathers (structure of arrays, as above)
        kick = tuple(jnp.take(field4[:, ax], flat) for ax in range(3))

        def out(a):
            return tuple(x.astype(out_dtype) for x in a)

        uray = uray.astype(out_dtype)
        return RayState(
            frac=out(frac), vel=out(vel), kick=out(kick),
            uray=jnp.where(mask, uray, jnp.asarray(0, out_dtype)),
            uray_init=jnp.where(mask, uray, jnp.asarray(1, out_dtype)),
            cell=tuple(cell), alive=mask)

    fn = jax.jit(init)
    while len(_DEVICE_INIT_CACHE) >= _DEVICE_INIT_CACHE_MAX:
        _DEVICE_INIT_CACHE.pop(next(iter(_DEVICE_INIT_CACHE)))
    _DEVICE_INIT_CACHE[key] = fn
    return fn


def live_tile_ids(cfg: Config, layout: TileLayout) -> np.ndarray:
    """Global ids (int32) of tiles with >=1 pupil-accepted ray, in traced
    order (beam-major, every beam with the same tile count).  The pupil
    pattern is beam-independent, so this is O(nrays) host work regardless
    of nbeams."""
    from ..beams import ray_permutation

    rpz, zones, tz = cfg.rays_per_zone, cfg.zones_spanned, cfg.tile_zones
    ntiles_axis = -(-zones // tz)
    kk = np.arange(cfg.nrays, dtype=np.int64)
    raynum = ray_permutation(cfg, kk)
    x0, y0 = lattice_xy(cfg, raynum % cfg.nrays_x, raynum // cfg.nrays_x)
    ok = np.sqrt(x0 * x0 + y0 * y0) <= cfg.beam_max_x
    if cfg.parity == "reference":
        ok &= kk < cfg.traced_rays_per_beam
    zx = kk // (rpz * rpz) % zones
    zy = kk // (rpz * rpz) // zones
    tile = (zy // tz) * ntiles_axis + (zx // tz)
    live_pattern = np.zeros(layout.tiles_per_beam, bool)
    np.logical_or.at(live_pattern, tile, ok)
    live = np.nonzero(live_pattern)[0]
    # every beam owns the same beam-contiguous tile count: the layout the
    # per-beam-sliced CBET gain lookups rely on (cbet.live_tile_slots)
    ids = np.concatenate([
        b * layout.tiles_per_beam + live for b in range(cfg.nbeams)])
    return ids.astype(np.int32)


def prepare_device(cfg: Config, prof: RadialProfiles | None = None,
                   beam_norm: np.ndarray | None = None) -> TraceContext:
    """Device-side Init: like :func:`prepare`, but the per-ray state is
    built ON the accelerator (make_device_init) and ``state0`` is already
    the live-tile, device-resident traced state —
    ``live_slots`` spans all of it.  Host work is O(grid + nrays), not
    O(nbeams * nrays): at BASELINE config 4 (64M rays) this replaces
    minutes of single-core NumPy and GB-scale uploads."""
    if prof is None:
        prof = load_profiles(nr=cfg.nr)
    if beam_norm is None:
        beam_norm = load_beam_norms(nbeams=cfg.nbeams)
    fields = build_fields(cfg, prof)
    layout = build_tile_layout(cfg, with_slots=False)
    dtype = jnp.dtype(cfg.dtype)

    d = np.array([cfg.dx, cfg.dy, cfg.dz])
    kick = fields.fgrad * cfg.dt / d
    f4 = np.concatenate([kick.reshape(-1, 3),
                         fields.absorb.reshape(-1, 1)], axis=1)
    field4 = jnp.asarray(f4, dtype)

    bn = beam_norm / np.linalg.norm(beam_norm, axis=1, keepdims=True)
    theta1 = np.arccos(beam_norm[:, 2])
    theta2 = np.arctan2(beam_norm[:, 1] * cfg.focal_length,
                        cfg.focal_length * beam_norm[:, 0])
    beam_tab = np.stack([np.cos(theta1), np.sin(theta1),
                         np.cos(theta2), np.sin(theta2),
                         bn[:, 0], bn[:, 1], bn[:, 2]], axis=1)

    ids = live_tile_ids(cfg, layout)
    fn = make_device_init(cfg, layout)
    # float64 launch arithmetic, rounded once to cfg.dtype (make_device_init)
    with jax.enable_x64(True):
        f64 = jnp.float64
        state0 = fn(field4, jnp.asarray(fields.wsq_term.reshape(-1), f64),
                    jnp.asarray(beam_tab, f64),
                    jnp.asarray(power_table(cfg), f64), jnp.asarray(ids))

    beam_id = np.repeat(ids // layout.tiles_per_beam,
                        layout.rays_per_tile).astype(np.int32)
    return TraceContext(
        cfg=cfg, prof=prof, beam_norm=beam_norm, fields=fields, rays=None,
        layout=layout, field4=field4, state0=state0, beam_id=beam_id,
        live_slots=np.arange(state0.n, dtype=np.int64), compact=True)


def select_rays(state: RayState, indices: np.ndarray) -> RayState:
    """Subset the ray batch by slot indices (tests, diagnostics).

    Host (NumPy) states stay on the host — see prepare(host_state=True)."""
    on_host = isinstance(state.uray, np.ndarray)
    idx = np.asarray(indices) if on_host else jnp.asarray(indices)
    return RayState(
        frac=tuple(a[idx] for a in state.frac),
        vel=tuple(a[idx] for a in state.vel),
        kick=tuple(a[idx] for a in state.kick),
        uray=state.uray[idx], uray_init=state.uray_init[idx],
        cell=tuple(a[idx] for a in state.cell),
        alive=state.alive[idx],
    )


def _reindex_axis(cell, frac, n: int, tol: float):
    """Countdown cell re-index (launch_ray_XZ.cu:282-292): of the candidates
    {cell-1, cell, cell+1} clipped to [0, n-1], the *smallest* within ``tol``
    of the position wins (the countdown loop's last write); else unchanged.

    Cell-relative: candidate offset d matches iff ``|d - frac| < tol``.
    Returns the chosen offset; no-match coincides with offset 0."""
    dsel = jnp.zeros_like(cell)
    for dlt in (1, 0, -1):
        ok = jnp.abs(jnp.asarray(dlt, frac.dtype) - frac) < tol
        if dlt == 1:
            ok &= cell + 1 <= n - 1
        elif dlt == -1:
            ok &= cell - 1 >= 0
        dsel = jnp.where(ok, jnp.full_like(cell, dlt), dsel)
    return dsel


def corner_parts(cfg: Config, cell, frac, inc, dims=None):
    """The 8 trilinear corners of each ray-step as ``[(flat index, value)]``
    on the ghost-padded grid — a transcription of the reference's corner
    scheme (launch_ray_XZ.cu:319-348).  ``dims`` overrides the (nx, ny, nz)
    node counts of the target grid (used by the CBET stage's coarsened
    intensity grids)."""
    if dims is None:
        dims = (cfg.nx, cfg.ny, cfg.nz)
    nyp, nzp = dims[1] + 2, dims[2] + 2
    dtype = inc.dtype
    p = [f - 0.5 for f in frac]
    dwt = [1.0 - jnp.abs(pp) for pp in p]            # dm, dn, dl
    sgn = [jnp.where(pp < 0, -1, 1).astype(jnp.int32) for pp in p]
    base = ((cell[0] + 1) * nyp + (cell[1] + 1)) * nzp + (cell[2] + 1)
    soff = [sgn[0] * (nyp * nzp), sgn[1] * nzp, sgn[2]]

    parts = []
    for ax_x in (0, 1):
        wx = dwt[0] if ax_x else (1.0 - dwt[0])
        ox = soff[0] if ax_x else 0
        for ax_y in (0, 1):
            wy = dwt[1] if ax_y else (1.0 - dwt[1])
            oy = soff[1] if ax_y else 0
            for ax_z in (0, 1):
                wz = dwt[2] if ax_z else (1.0 - dwt[2])
                oz = soff[2] if ax_z else 0
                parts.append((base + ox + oy + oz,
                              (wx * wy * wz * inc).astype(dtype)))
    return parts


def _scatter_corner_parts(cfg: Config, cell, frac, inc, dims=None):
    """Flattened (8N,) corner indices/values for the XLA scatter deposit."""
    parts = corner_parts(cfg, cell, frac, inc, dims)
    return (jnp.concatenate([i for i, _ in parts]),
            jnp.concatenate([v for _, v in parts]))


def _scatter_deposit(cfg: Config, edep3d, cell, frac, inc):
    """The trilinear deposit: one (8N,) 1-D XLA scatter-add."""
    idx, val = _scatter_corner_parts(cfg, cell, frac, inc)
    flat = edep3d.reshape(-1).at[idx].add(val)
    return flat.reshape(edep3d.shape)


def _take_rows(field4, flat):
    """The step's one field-table lookup: the (kick_x, kick_y, kick_z,
    absorb) columns of the (P, 4) rows at ``flat``."""
    rows = jnp.take(field4, flat, axis=0)
    return tuple(rows[:, c] for c in range(4))


def make_deferred_step_fn(cfg: Config, gather=_take_rows):
    """THE step physics (one iteration of the reference time loop,
    launch_ray_XZ.cu:207-357, over the whole ray batch): advances the state
    and returns the deposit inputs (cell, frac, masked increment) for the
    caller to deposit — per step (make_step_fn wraps this with the deposit)
    or batched per window.  The gradient kick at the current cell was
    row-gathered by the PREVIOUS step (the reference evaluates the stencil
    at the loop-entry cell — exactly the carried value); the one gather per
    step fetches kick-for-next-step + absorption at the new cell in a
    single interleaved (N, 4) row.  ``gather(field4, flat)`` is that lookup
    (a fused kernel passes its own, reading the table from a kernel
    reference)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    tol = cfg.cell_tol
    stop_frac = cfg.stop_fraction
    absorption = cfg.absorption
    nvec = (nx, ny, nz)

    def step(state: RayState, field4: jnp.ndarray):
        dtype = state.uray.dtype
        vel = tuple(state.vel[ax] - state.kick[ax] for ax in range(3))
        frac = tuple(state.frac[ax] + vel[ax] for ax in range(3))
        dsel = tuple(_reindex_axis(state.cell[ax], frac[ax], nvec[ax], tol)
                     for ax in range(3))
        cell = tuple(state.cell[ax] + dsel[ax] for ax in range(3))
        frac = tuple(frac[ax] - dsel[ax].astype(dtype) for ax in range(3))
        flat2 = (cell[0] * ny + cell[1]) * nz + cell[2]
        *kick, absorb = gather(field4, flat2)
        if absorption:
            increment = absorb * state.uray
            uray = state.uray - increment
        else:
            increment = state.uray
            uray = state.uray
        inc_masked = jnp.where(state.alive, increment, jnp.asarray(0, dtype))
        out = jnp.zeros_like(state.alive)
        for ax in range(3):
            t = cell[ax].astype(dtype) + frac[ax]
            out |= (t < -0.5) | (t > nvec[ax] - 0.5)
        dead = (uray <= stop_frac * state.uray_init) | out
        alive = state.alive & jnp.logical_not(dead)
        keep = state.alive
        new_state = RayState(
            frac=tuple(jnp.where(keep, frac[ax], state.frac[ax]) for ax in range(3)),
            vel=tuple(jnp.where(keep, vel[ax], state.vel[ax]) for ax in range(3)),
            kick=tuple(jnp.where(keep, kick[ax], state.kick[ax]) for ax in range(3)),
            uray=jnp.where(keep, uray, state.uray),
            uray_init=state.uray_init,
            cell=tuple(jnp.where(keep, cell[ax], state.cell[ax]) for ax in range(3)),
            alive=alive,
        )
        return new_state, (cell, frac, inc_masked)

    return step


def make_step_fn(cfg: Config):
    """Build the pure per-step function
    ``(state, edep3d, field4) -> (state, edep3d, overflow)``.

    Transcribes one iteration of the reference time loop
    (launch_ray_XZ.cu:207-357) over the whole ray batch.  The physics is
    make_deferred_step_fn's (ONE copy — the segmented/plan paths use the
    deferred variant directly, so they cannot drift); this wrapper only
    adds the scatter deposit of the returned (cell, frac, inc).  The
    scatter never drops a deposit (every corner index lies inside the
    ghost-padded grid), so ``overflow`` is always 0 here; it is kept in the
    signature so every trace path reports lost deposits the same way."""
    dstep = make_deferred_step_fn(cfg)

    def step(state: RayState, edep3d: jnp.ndarray, field4: jnp.ndarray):
        new_state, (cell, frac, inc_masked) = dstep(state, field4)
        edep3d = _scatter_deposit(cfg, edep3d, cell, frac, inc_masked)
        return new_state, edep3d, jnp.int32(0)

    return step


def _make_chunk_machinery(cfg: Config):
    """Shared core of the trace functions: the per-chunk scan body (chunked
    f32 accumulation, all-dead early exit) plus the chunking facts it
    closes over."""
    step = make_step_fn(cfg)
    shape3 = cfg.edep_shape
    chunk = max(1, min(cfg.chunk_steps, cfg.nt))
    n_chunks = -(-cfg.nt // chunk)          # ceil
    last_chunk = cfg.nt - (n_chunks - 1) * chunk

    def make_chunk_body(field4, compute_dtype):
        def chunk_body(carry, steps_in_chunk):
            state, master, oflow = carry

            def inner(carry2, _):
                state2, edep32, of2 = carry2
                state2, edep32, of_step = step(state2, edep32, field4)
                return (state2, edep32, of2 + of_step), None

            edep32 = jnp.zeros(shape3, compute_dtype)

            def run_inner(n_steps):
                return jax.lax.scan(inner, (state, edep32, oflow), None,
                                    length=n_steps)[0]

            def run_chunk():
                if last_chunk == chunk:
                    return run_inner(chunk)
                return jax.lax.cond(
                    steps_in_chunk == chunk,
                    lambda: run_inner(chunk),
                    lambda: run_inner(last_chunk),
                )

            # early exit: once every ray has terminated, remaining chunks are
            # pure no-ops (the CUDA `break` analog at chunk granularity)
            state, edep32, oflow = jax.lax.cond(
                jnp.any(state.alive),
                run_chunk,
                lambda: (state, edep32, oflow),
            )
            master = master + edep32.astype(master.dtype)
            return (state, master, oflow), None

        return chunk_body

    return make_chunk_body, chunk, last_chunk, n_chunks


def master_dtype(cfg: Config):
    """The master grid's dtype: ``edep_dtype`` canonicalized — float64
    degrades to float32 when x64 is off; the chunked float32 accumulation
    keeps the summation error bounded either way."""
    return jax.dtypes.canonicalize_dtype(jnp.dtype(cfg.edep_dtype))


def make_trace_fn(cfg: Config):
    """Build the jittable full-trace function
    ``(field4, state0) -> (edep, final_state, overflow)``.

    Runs ``nt`` steps as an outer scan over chunks of ``chunk_steps``; each
    chunk accumulates deposits in float32 and promotes into an ``edep_dtype``
    master grid between chunks (summation-error control).  ``overflow``
    counts lost deposits (see make_step_fn)."""
    make_chunk_body, chunk, last_chunk, n_chunks = _make_chunk_machinery(cfg)

    def trace(field4, state0: RayState):
        master = jnp.zeros(cfg.edep_shape, master_dtype(cfg))
        chunk_body = make_chunk_body(field4, state0.uray.dtype)
        steps_per_chunk = jnp.asarray(
            [chunk] * (n_chunks - 1) + [last_chunk], jnp.int32)
        (state, master, oflow), _ = jax.lax.scan(
            chunk_body, (state0, master, jnp.int32(0)), steps_per_chunk)
        return master, state, oflow

    return trace


def make_segmented_trace_fn(cfg: Config, rays_per_tile: int, segments,
                            track_final_state: bool = False):
    """Full-trace function with static mid-trace tile compaction
    (models/tileplan.py): between segments, the ray state is gathered down
    to the tiles still depositing — a STATIC gather (the per-chunk live-tile
    sets are deterministic for a fixed config+scene), so the whole compacted
    trace is one jittable function with no host round-trips.

    ``state0`` must be tile-aligned with ``segments[0]`` (the plan must have
    been measured on the same state, tileplan.measure_plan).  The returned
    final state covers the LAST segment's tiles; use
    ``segment_slot_origins(segments, rays_per_tile)`` to map its slots back
    to state0 slots (e.g. for trace_stats).  Single-device only — shards
    need per-device-balanced plans (parallel/sharding.py).

    ``track_final_state=True`` appends ``(uray_full, alive_full)`` —
    full-length (state0.n,) arrays holding every slot's *final* energy and
    liveness, assembled by writing each segment's values back at its slot
    origins before compaction drops them (static scatters at segment
    boundaries only).  This restores the complete termination/energy
    accounting (trace_stats) that plain compaction would lose."""
    make_chunk_body, _, _, n_chunks = _make_chunk_machinery(cfg)
    assert sum(len(s.chunk_lengths) for s in segments) == n_chunks

    # static gather indices between consecutive segments, at TILE-row
    # granularity: gathering (T_prev, rays_per_tile) rows moves whole
    # contiguous blocks instead of single elements.  segment_gather_rows maps
    # tile ids to prev's FULL row layout, so it is correct even when a
    # segment list interleaves valid and pad rows (per-beam blocks) — the
    # earlier searchsorted over prev's compressed valid tiles was only
    # correct for build_segments' pads-as-suffix layout and gathered wrong
    # rows silently for any other.
    from .tileplan import segment_gather_rows
    T_all = int(segments[0].tiles.max()) + 1
    gathers = []
    for prev, seg in zip(segments[:-1], segments[1:]):
        pos = segment_gather_rows(prev, seg, T_all)
        valid = np.repeat(seg.valid, rays_per_tile)
        gathers.append((len(prev.tiles), jnp.asarray(pos),
                        jnp.asarray(valid)))

    n0 = len(segments[0].tiles) * rays_per_tile
    if track_final_state:
        # per-segment slot origins in segment-0 space; pad (invalid) rows
        # write to index n0 and are dropped by the scatter
        from .tileplan import origin_slots
        origins = [jnp.asarray(origin_slots(seg.tiles, seg.valid,
                                            rays_per_tile, n0))
                   for seg in segments]

    def trace(field4, state0: RayState):
        master = jnp.zeros(cfg.edep_shape, master_dtype(cfg))
        chunk_body = make_chunk_body(field4, state0.uray.dtype)
        state, oflow = state0, jnp.int32(0)
        if track_final_state:
            uray_full, alive_full = state0.uray, state0.alive

        def write_back(uray_full, alive_full, si):
            ix = origins[si]
            return (uray_full.at[ix].set(state.uray, mode="drop"),
                    alive_full.at[ix].set(state.alive, mode="drop"))

        for si, seg in enumerate(segments):
            if si > 0:
                if track_final_state:
                    uray_full, alive_full = write_back(
                        uray_full, alive_full, si - 1)
                t_prev, pos, valid = gathers[si - 1]

                def take_tiles(a, t_prev=t_prev, pos=pos):
                    return a.reshape(t_prev, rays_per_tile)[pos].reshape(-1)

                state = jax.tree_util.tree_map(take_tiles, state)
                state = dataclasses.replace(state, alive=state.alive & valid)
            steps = jnp.asarray(seg.chunk_lengths, jnp.int32)
            (state, master, oflow), _ = jax.lax.scan(
                chunk_body, (state, master, oflow), steps)
        if track_final_state:
            uray_full, alive_full = write_back(
                uray_full, alive_full, len(segments) - 1)
            return master, state, oflow, (uray_full, alive_full)
        return master, state, oflow

    return trace


def segment_slot_origins(segments, rays_per_tile: int) -> np.ndarray:
    """Map the final segment's slots back to segment-0 slots (for stats):
    returns (n_final_slots,) int64, -1 for pad slots."""
    from .tileplan import origin_slots
    last = segments[-1]
    return origin_slots(last.tiles, last.valid, rays_per_tile, drop_to=-1)


def make_chunk_fn(cfg: Config, n_steps: int):
    """Jittable single-chunk advance for resumable tracing:
    ``(field4, state, master, oflow) -> (state, master, oflow)``."""
    step = make_step_fn(cfg)

    def chunk(field4, state: RayState, master, oflow):
        edep32 = jnp.zeros(cfg.edep_shape, state.uray.dtype)

        def inner(carry, _):
            st, e, of = carry
            st, e, o = step(st, e, field4)
            return (st, e, of + o), None

        (state, edep32, oflow), _ = jax.lax.scan(
            inner, (state, edep32, oflow), None, length=n_steps)
        return state, master + edep32.astype(master.dtype), oflow

    return chunk


def make_chunk_delta_fn(cfg: Config):
    """Host-dispatched single-chunk advance with the full chunk machinery:
    ``(field4, state, oflow, steps_in_chunk) -> (state, delta_f32, oflow)``.

    Unlike :func:`make_chunk_fn` (master-accumulating), this returns the
    chunk's deposits on a fresh float32 grid so the host loop owns master
    accumulation (pairwise summation at BASELINE-config-4 scale, where the
    master must be float64-equivalent without x64).  ``steps_in_chunk``
    must be ``cfg.chunk_steps`` or the final partial chunk length."""
    make_chunk_body = _make_chunk_machinery(cfg)[0]

    def chunk_fn(field4, state: RayState, oflow, steps_in_chunk):
        body = make_chunk_body(field4, state.uray.dtype)
        (state, delta, oflow), _ = body(
            (state, jnp.zeros(cfg.edep_shape, jnp.float32), oflow),
            steps_in_chunk)
        return state, delta, oflow

    return chunk_fn


def trace(ctx: TraceContext):
    """Convenience single-device full trace (live tiles only).  Returns
    (edep [np.f64 padded], final RayState over live slots)."""
    fn = jax.jit(make_trace_fn(ctx.cfg))
    state0 = select_rays(ctx.state0, ctx.live_slots)
    edep, state, oflow = fn(ctx.field4, state0)
    check_overflow(int(jax.device_get(oflow)))
    return np.asarray(jax.device_get(edep), dtype=np.float64), state


def check_overflow(oflow: int) -> None:
    """Raise on lost deposits — silent data loss must never pass.

    A RuntimeError (not ``assert``) so the guard survives ``python -O``."""
    if oflow:
        raise RuntimeError(f"deposit overflow: {oflow} deposits lost")


def trace_stats(ctx: TraceContext, state: RayState,
                state0: RayState | None = None) -> dict[str, Any]:
    """Run metrics the reference lacks (SURVEY.md §5.5): launch/termination
    accounting and energy bookkeeping.

    ``state0`` is the initial state actually traced (it may be a live-tile
    subset of ``ctx.state0``, possibly padded); defaults to ``ctx.state0``,
    which is only valid when the final state has the same slot count —
    passing a compacted/padded final state without its matching ``state0``
    would silently misalign the slot-for-slot accounting, so that raises."""
    if state0 is None:
        state0 = ctx.state0
    if state0.n != state.uray.shape[0]:
        # an explicit state0 must match too: truncating to the shorter of
        # the two would compare slots from DIFFERENT layouts (e.g. a
        # compacted last-segment state against segment-0 order) and return
        # silently wrong termination/energy numbers
        raise ValueError(
            f"final state has {state.uray.shape[0]} slots but state0 has "
            f"{state0.n}: slot-for-slot accounting needs the same layout — "
            "for segmented traces map the final state back with "
            "segment_slot_origins / track_final_state first")
    launched_mask = np.asarray(state0.alive)
    launched = int(launched_mask.sum())
    alive_end = int(np.asarray(state.alive).sum())
    uray = np.asarray(state.uray, np.float64)
    uinit = np.asarray(state.uray_init, np.float64)
    absorbed = float(np.sum((uinit - uray)[launched_mask]))
    return {
        "rays_total": int(ctx.cfg.total_rays),
        "rays_launched": launched,
        "rays_alive_at_end": alive_end,
        "rays_terminated": launched - alive_end,
        "energy_launched": float(np.sum(uinit[launched_mask])),
        "energy_absorbed": absorbed,
    }
