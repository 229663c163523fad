"""Cross-beam energy transfer (CBET) — the stage the reference scaffolds but
does not implement (def.cuh:94-114: ``constant1``, ``iaw``, ``cs``, ``mach``,
``numstored``/``ncrossings`` capacities; SURVEY.md §2.15).

Model (standard ray-based CBET, honoring the reference's constants contract):

* Each beam ``b`` carries a node intensity field ``I_b`` built from its rays'
  per-step deposits of ``uray * |v| / c`` — the discrete analog of the
  per-cell crossing records the reference reserves capacity for
  (``numstored``, def.cuh:94).  The |v|/c weight converts the bookkeeping sum
  (which over-counts each cell by the ~c/(|v|*courant) steps a ray spends in
  it) into the local beam intensity in W/cm^2: a full-power beam crossing a
  cell yields I ~ ``intensity`` (1e14), growing toward the focus as the
  spherical geometry converges — the scale at which ``constant1`` gives
  physical gains of order 0.1-1 over the path.
* Between two beams with unit propagation directions k̂_b, k̂_b' (equal
  frequencies — all OMEGA beams are 3ω), the ion-acoustic resonance parameter
  at a cell with radial flow û = r̂ is

      eta = -((k̂_b' - k̂_b) · û) * machnum * cs / (|k̂_b' - k̂_b| cs)
          = -machnum * (unit(k̂_b' - k̂_b) · r̂)

  (def.cuh:99 ``mach = -sqrt(2)`` is "the Mach number for max resonance":
  |unit(Δk̂)·r̂| <= 1 and two beams at 90° give |Δk̂|=sqrt(2), so eta reaches
  1 exactly at resonance).
* The resonance response ``P(eta) = iaw^2 eta / ((eta^2-1)^2 + iaw^2 eta^2)``
  (odd in eta: pairwise exchange is antisymmetric), and the per-length gain
  on a ray of beam b:

      g_b(cell) = constant1 * (ne/ncrit)/sqrt(1-ne/ncrit)
                  * sum_{b'} P(eta_{b,b'}) * I_b'(cell)

  with ``constant1`` exactly def.cuh:111.  Ray energies update per step as
  ``uray *= exp(g_b * ds)`` with path element ``ds = |v| dt``.
* Fixed point: trace -> intensity fields -> gains -> retrace, with
  under-relaxation of the intensity update, until the relative field change
  drops below ``cbet_tol`` (a batched fixed-point iteration over beams, not
  the reference's absent serial loop).

Recompute-over-store: each iteration re-traces rays instead of storing
``ncrossings``-bounded per-ray crossing lists (trajectories are cheap to
recompute; device memory is better spent on fields).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as k
from ..config import Config
from . import raytracer as rt

# Stability clamp on the per-step gain exponent (only engages at transient
# resonance hotspots during early fixed-point iterations; physical per-step
# gains are O(1e-3..3e-2)).  THE single value for both gain paths — the
# lookup-mode apply_gain and the window branch — which must stay identical
# or the modes silently compute different models.
GAIN_CLIP = 0.1


@dataclasses.dataclass
class CbetResult:
    edep: np.ndarray          # ghost-padded deposition with CBET-coupled rays
                              # (always full-resolution)
    intensity: np.ndarray     # (nbeams, *cfg.cbet_grid_shape) final node
                              # intensity fields (coarsened when
                              # cbet_grid_downsample > 1)
    iterations: int
    converged: bool
    history: list             # per-iteration relative field change
    stats: dict[str, Any]


def pair_couplings(beam_norm: np.ndarray, machnum: float) -> np.ndarray:
    """Per-beam-pair unit difference vectors scaled for eta:
    ``eta[b,b',cell] = pair_u[b,b'] . r_hat(cell)``; zero on the diagonal so
    self-coupling vanishes through P(0)=0."""
    khat = -beam_norm / np.linalg.norm(beam_norm, axis=1, keepdims=True)
    dk = khat[None, :, :] - khat[:, None, :]           # (B, B, 3)
    norm = np.linalg.norm(dk, axis=-1, keepdims=True)
    unit = np.where(norm > 1e-12, dk / np.where(norm == 0, 1, norm), 0.0)
    return -machnum * unit                             # (B, B, 3)


# intensity (W/cm^2) -> squared-field CGS units entering the CGS gain
# prefactor constant1 (def.cuh:111): I[W/cm^2] * 1e7 -> erg/s/cm^2, * 8pi/c
# -> statvolt^2/cm^2
I_TO_FIELD_SQ = 8.0 * np.pi * 1.0e7 / k.C_CMS


def gain_prefactor_field(cfg: Config, fields) -> np.ndarray:
    """A(cell) = constant1 * (ne/ncrit)/sqrt(1-ne/ncrit) * (8pi 1e7/c).

    ne/ncrit is capped at 0.95: the 1/sqrt(1-ne/nc) ion-acoustic response
    diverges at the critical surface where the ray model breaks down anyway
    (rays turn and absorb before nc); the cap keeps hotspot gains finite."""
    frac = np.clip(fields.eden / k.NCRIT, 0.0, 0.95)
    return k.CONSTANT1 * I_TO_FIELD_SQ * frac / np.sqrt(1.0 - frac)


def resonance(eta: jnp.ndarray, iaw: float = k.IAW) -> jnp.ndarray:
    e2 = eta * eta
    return (iaw * iaw) * eta / ((e2 - 1.0) ** 2 + (iaw * iaw) * e2)


def make_gain_fn(cfg: Config, ctx: rt.TraceContext):
    """Jitted ``I (B, P) -> G (B, P)`` on the (possibly coarsened, see
    Config.cbet_grid_downsample) unpadded CBET node grid.

    The reduction must never materialize its (B, B, P) intermediate (14 GB
    at OMEGA scale): a ``fori_loop`` over partner beams accumulates in
    (B, P), so each partner costs one elementwise pass over the (B, P)
    accumulator."""
    s = cfg.cbet_grid_downsample
    dtype = jnp.dtype(cfg.dtype)
    rhat = _node_rhat(cfg, s)                           # (3, P)
    pre = gain_prefactor_field(cfg, ctx.fields)[::s, ::s, ::s].reshape(-1)
    pair_j = jnp.asarray(pair_couplings(ctx.beam_norm, cfg.machnum),
                         dtype)                         # (B, B, 3)
    rhat_j = jnp.asarray(rhat, dtype)
    pre_j = jnp.asarray(pre, dtype)

    def gain(intensity):                                # (B, P)
        intensity = intensity.astype(dtype)

        def body(bp, acc):
            eta = (jax.lax.dynamic_slice_in_dim(pair_j[:, :, 0], bp, 1, 1)
                   * rhat_j[0][None, :]
                   + jax.lax.dynamic_slice_in_dim(pair_j[:, :, 1], bp, 1, 1)
                   * rhat_j[1][None, :]
                   + jax.lax.dynamic_slice_in_dim(pair_j[:, :, 2], bp, 1, 1)
                   * rhat_j[2][None, :])                 # (B, P)
            ib = jax.lax.dynamic_slice_in_dim(intensity, bp, 1, 0)  # (1, P)
            return acc + resonance(eta) * ib

        g = jax.lax.fori_loop(0, cfg.nbeams, body, jnp.zeros_like(intensity))
        return g * pre_j[None, :]

    return jax.jit(gain)


def _node_rhat(cfg: Config, s: int = 1) -> np.ndarray:
    """Unit radial vectors at the CBET-grid nodes (full-grid indices
    0, s, 2s, ...)."""
    x = np.arange(0, cfg.nx, s) * cfg.dx + cfg.xmin
    y = np.arange(0, cfg.ny, s) * cfg.dy + cfg.ymin
    z = np.arange(0, cfg.nz, s) * cfg.dz + cfg.zmin
    gx, gy, gz = np.meshgrid(x, y, z, indexing="ij")
    r = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    r = np.where(r > 1e-12, r, 1.0)
    return np.stack([(gx / r).reshape(-1), (gy / r).reshape(-1),
                     (gz / r).reshape(-1)])


def _interp_matrix(n_full: int, nh: int, s: int) -> np.ndarray:
    """(n_full, nh) linear-interpolation matrix from coarse nodes (full
    indices 0, s, 2s, ...), clamped at the upper edge.  Two nonzeros per
    row, used as a dense matmul operand."""
    t = np.arange(n_full) / s
    lo = np.minimum(np.floor(t).astype(int), nh - 1)
    hi = np.minimum(lo + 1, nh - 1)
    w = t - lo
    m = np.zeros((n_full, nh), np.float32)
    m[np.arange(n_full), lo] += 1.0 - w
    m[np.arange(n_full), hi] += w
    return m


def make_gain_upsampler(cfg: Config):
    """Jitted trilinear upsample of a coarse (B, Ph) gain field to the full
    (B, P) node grid — one call per fixed-point iteration when
    ``cbet_grid_downsample > 1`` (the per-step gain lookup stays
    full-resolution; see make_cbet_trace_fn).

    Three small dense matmuls (separable per-axis interpolation matrices),
    gather- and repeat-free.  ``precision=HIGHEST`` keeps them in float32:
    the default lets a GPU run float32 matmuls in TF32 (~3 digits)."""
    s = cfg.cbet_grid_downsample
    hx, hy, hz = cfg.cbet_grid_shape
    wx = jnp.asarray(_interp_matrix(cfg.nx, hx, s))
    wy = jnp.asarray(_interp_matrix(cfg.ny, hy, s))
    wz = jnp.asarray(_interp_matrix(cfg.nz, hz, s))
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def upsample(gain_h):                      # (B, Ph)
        g = gain_h.reshape(-1, hx, hy, hz)
        g = jnp.einsum("bxyz,Zz->bxyZ", g, wz, precision=hi)
        g = jnp.einsum("bxyZ,Yy->bxYZ", g, wy, precision=hi)
        g = jnp.einsum("bxYZ,Xx->bXYZ", g, wx, precision=hi)
        return g.reshape(g.shape[0], cfg.nx * cfg.ny * cfg.nz)

    return upsample


def live_tile_slots(cfg: Config, ctx: rt.TraceContext) -> np.ndarray:
    """Per-beam live-tile slot selection for CBET traces.

    Like ``ctx.live_slots`` (launched-tile compaction, ~24% fewer slots on
    the OMEGA scene) but asserting the beam-contiguous uniform layout the
    per-beam-sliced gain lookups rely on: the pupil mask is
    beam-independent (it applies in the pre-rotation lattice frame,
    launch_ray_XZ.cu:94,114), so every beam has the same live count."""
    rpt = ctx.layout.rays_per_tile
    tpb = ctx.layout.tiles_per_beam
    mask = np.asarray(ctx.state0.alive)
    tile_live = mask.reshape(-1, rpt).any(axis=1).reshape(cfg.nbeams, tpb)
    counts = tile_live.sum(axis=1)
    # RuntimeError, not assert: a violation silently corrupts the sliced
    # lookups' positional beam attribution, and asserts vanish under -O
    if not (counts == counts[0]).all():
        raise RuntimeError(
            f"per-beam live-tile counts differ ({counts.tolist()}) — the "
            "beam-independent pupil assumption this layout relies on does "
            "not hold for this scene")
    tiles = np.nonzero(tile_live.reshape(-1))[0]
    return (tiles[:, None] * rpt + np.arange(rpt)[None, :]).reshape(-1)


def make_cbet_trace_fn(cfg: Config, ctx: rt.TraceContext,
                       sharded: bool = False,
                       tiles_per_group: int | None = None,
                       edep_skip: bool = False):
    """Gain-aware trace:
    ``(field4, gain (B,P), bid (N,), state0) -> (edep, intensity (B,Ph),
    state, overflow)`` (``bid`` = per-slot beam ids, sharded alongside the
    rays in multi-device solves).

    Extends the base integrator step with the multiplicative CBET gain and
    per-beam intensity accumulation (trilinear deposit of ``uray*|v|/c`` —
    the crossing-record analog) as one scatter into per-beam grids through
    beam offsets.

    ``sharded`` builds the per-shard body of a mesh solve (the caller wraps
    it in ``shard_map`` and psums edep and intensity): a shard's slots are
    not beam-contiguous, so the gain lookup uses the flat beam-offset
    gather instead of the per-beam-sliced one.  ``tiles_per_group`` is the
    beam-contiguous layout's tiles per beam (default: the layout's).
    ``edep_skip`` drops the edep scatter (light iterations, window gain
    modes only)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    base_step = rt.make_step_fn(cfg)
    # the CBET intensity/gain grid may be coarser than the trace grid
    # (Config.cbet_grid_downsample); all CBET-side indexing below is in
    # coarse-node units, the edep path stays full-resolution
    s = cfg.cbet_grid_downsample
    hx, hy, hz = cfg.cbet_grid_shape
    P = nx * ny * nz              # per-step gain lookups are full-resolution
    nb = cfg.nbeams
    d = np.array([cfg.dx, cfg.dy, cfg.dz])
    sliced = cfg.cbet_gain_sliced and not sharded
    tpg = (tiles_per_group if tiles_per_group is not None
           else ctx.layout.tiles_per_beam)
    rpt = ctx.layout.rays_per_tile

    chunk = max(1, min(cfg.chunk_steps, cfg.nt))
    n_chunks = -(-cfg.nt // chunk)
    last_chunk = cfg.nt - (n_chunks - 1) * chunk

    kernel_gain = cfg.cbet_gain_mode in ("kernel", "kernel_cell")
    kernel_cell = cfg.cbet_gain_mode == "kernel_cell"
    batch = cfg.deposit_batch_steps
    if kernel_gain and (batch <= 1 or chunk % batch or last_chunk % batch):
        # the window model is defined per deposit window: fail loud rather
        # than silently compute a different model
        raise ValueError(
            f"cbet_gain_mode={cfg.cbet_gain_mode!r} requires "
            "deposit_batch_steps > 1 dividing the chunk lengths "
            f"(got {batch} for chunks of {chunk}/{last_chunk} steps)")
    if edep_skip and not kernel_gain:
        raise ValueError(
            "edep_skip (light CBET iterations) requires a window gain mode "
            "(cbet_gain_mode 'kernel' or 'kernel_cell')")
    if kernel_gain:
        # the window mini-scan advances WITHOUT the energy stop rule:
        # trajectories are energy-independent, and the exact rule is
        # applied by the window machinery itself (which knows the true
        # gained energy u_nogain * gcum per step) — deposits are masked
        # past each ray's true death step and uray/alive are restored
        # exactly at the window boundary.  Only positions/vel of
        # mid-window energy-dead rays differ from the per-step lookup
        # (frozen at window end instead of the death step) — no
        # parity-bearing output depends on them.
        dstep_win = rt.make_deferred_step_fn(cfg.replace(stop_fraction=0.0))
        stop_frac_w = cfg.stop_fraction
    grid_elems = (hx + 2) * (hy + 2) * (hz + 2)

    def to_coarse(cell, frac):
        """Full-grid (cell, frac) -> coarse-grid (cell, frac): the position
        t = cell + frac in full node units equals s * (ch + fh)."""
        if s == 1:
            return tuple(cell), tuple(frac)
        ch = tuple(c // s for c in cell)
        fh = tuple(((cell[a] - ch[a] * s).astype(frac[a].dtype) + frac[a])
                   * (1.0 / s) for a in range(3))
        return ch, fh

    def trace(field4, gain, bid, state0: rt.RayState):
        dtype = state0.uray.dtype
        dvec = jnp.asarray(d, dtype)
        # intensity is deposited per coarse-node *density*: a coarse node
        # collects s^3 more ray-step weight than a full-grid node, so the
        # per-step contribution carries a 1/s^3 normalization
        inv_cdt = jnp.asarray(1.0 / (k.C_CMS * cfg.dt * s ** 3), dtype)
        # flat 1-D gain lookup with a precomputed per-slot beam offset
        # (the sharded fallback of the sliced lookups below)
        gain_flat = gain.reshape(-1)
        bid = bid.astype(jnp.int32)
        bid_off = bid * jnp.int32(P)
        ioff = jnp.concatenate([bid * grid_elems] * 8)
        # 2-wide sliced gain rows (Config.cbet_gain_rows2): gathers from a
        # value-duplicated (B, P, 2) table when it fits.  Built once per
        # trace call (outside the step scans).
        rows2 = cfg.cbet_gain_rows2
        if rows2 is None:
            rows2 = int(gain.size) * gain.dtype.itemsize * 2 <= 1.5e9
        gain_src = (jnp.stack([gain, gain], axis=-1) if rows2 and sliced
                    else gain)
        if kernel_gain and not kernel_cell:
            # per-beam gain tables in the grid's own ghost-padded layout
            # (ghost nodes = zero gain) for the trilinear corner gathers;
            # built once per trace call
            g3 = gain.reshape(nb, nx, ny, nz)
            gpad_flat = jnp.pad(
                g3, ((0, 0), (1, 1), (1, 1), (1, 1))).reshape(-1)
            grid_pad = (nx + 2) * (ny + 2) * (nz + 2)
            bid_off_pad = bid * jnp.int32(grid_pad)

        def deposit_intensity(ibeams, cell, frac, contrib):
            # one scatter into the per-beam grids via beam offsets
            icell, ifrac = to_coarse(cell, frac)
            idx, val = rt._scatter_corner_parts(cfg, icell, ifrac, contrib,
                                                dims=(hx, hy, hz))
            return ibeams.reshape(-1).at[idx + ioff].add(val).reshape(
                ibeams.shape)

        def lookup_g(state, flat=None):
            # the lookup table is ALWAYS full-resolution (coarsened gain
            # fields are trilinearly upsampled once per fixed-point
            # iteration, cbet_solve) — nearest-coarse-node lookups were
            # measured to distort the coupled edep by >half the CBET
            # effect on the two-beam validation scene.  ``flat``
            # (precomputed flat cell indices) lets the kernel_cell window
            # branch reuse the sliced path.
            if flat is None:
                cx, cy, cz = state.cell
                flat = (cx * ny + cy) * nz + cz
            if not sliced:
                return jnp.take(gain_flat, bid_off + flat, axis=0)
            # per-beam-sliced gathers (identical values): each beam's
            # contiguous slot block reads its own gain row
            W = tpg * rpt
            if nb * W != flat.shape[0]:
                raise ValueError(
                    f"cbet_gain_sliced needs a beam-contiguous layout of "
                    f"exactly beams*tiles_per_group*rays_per_tile slots "
                    f"(= {nb}*{tpg}*{rpt} = {nb * W}), got {flat.shape[0]}"
                    " — pass the matching tiles_per_group or disable "
                    "slicing")
            taken = [jnp.take(gain_src[b], flat[b * W:(b + 1) * W], axis=0)
                     for b in range(nb)]
            if gain_src.ndim == 3:    # 2-wide rows: keep col 0
                taken = [t[:, 0] for t in taken]
            return jnp.concatenate(taken)

        def path_element(state):
            return jnp.sqrt((state.vel[0] * dvec[0]) ** 2
                            + (state.vel[1] * dvec[1]) ** 2
                            + (state.vel[2] * dvec[2]) ** 2)

        def apply_gain(state):
            # CBET gain along the path element of this step, looked up at
            # the step-entry cell; the stability clamp on the per-step
            # exponent only engages at transient resonance hotspots during
            # early fixed-point iterations
            ds = path_element(state)
            factor = jnp.exp(jnp.clip(lookup_g(state) * ds,
                                      -GAIN_CLIP, GAIN_CLIP))
            uray = jnp.where(state.alive, state.uray * factor, state.uray)
            return dataclasses.replace(state, uray=uray), ds

        def mini_nogain(st, _):
            # window model: advance WITHOUT gain and WITHOUT the energy stop
            # rule (gain and absorption are both multiplicative on uray, so
            # the window's cumulative gain factors apply exactly
            # afterwards); ds is the step-entry path element — the SAME
            # quadrature as the lookup mode's apply_gain, so the g->0 limit
            # of the two modes is identical — and zero on dead rays so
            # their window factor is exactly 1.  Emits the gain-free
            # post-step energy and the launch energy so the exact death
            # rule (u_nogain * gcum <= stop * uinit) can be evaluated per
            # step downstream.
            ds = jnp.where(st.alive, path_element(st), jnp.asarray(0, dtype))
            st, (cell, frac, inc) = dstep_win(st, field4)
            contrib0 = jnp.where(st.alive, st.uray * (ds * inv_cdt),
                                 jnp.asarray(0.0, dtype))
            return st, (*cell, *frac, inc, ds, contrib0,
                        st.uray, st.uray_init)

        def step_window(carry, _):
            # cbet_gain_mode="kernel": trilinear gain at every step's
            # deposit position via 8-corner gathers.  "kernel_cell": the
            # lookup mode's exact sampling (single node at each step's
            # ENTRY cell) applied in window form — entry cell j = post-step
            # cell j-1, the window-entry cell for j=0.  Both modes apply
            # the EXACT termination rule from the true gained energy (see
            # mini_nogain): kernel_cell is therefore IDENTICAL to the
            # per-step lookup model.
            state, edep, ibeams, oflow = carry
            cells0 = state.cell
            state, ys = jax.lax.scan(mini_nogain, state, None, length=batch)
            cell, frac = ys[0:3], ys[3:6]      # (batch, N) each
            inc, dsb, contrib0 = ys[6], ys[7], ys[8]
            u_ng, uinit_b = ys[9], ys[10]
            if kernel_cell:
                gs, prev = [], cells0
                for j in range(batch):
                    fl = (prev[0] * ny + prev[1]) * nz + prev[2]
                    gs.append(lookup_g(None, flat=fl))
                    prev = tuple(c[j] for c in cell)
                g = jnp.stack(gs)               # (batch, N)
            else:
                ones = jnp.ones_like(dsb[0])
                gs = []
                for j in range(batch):
                    cj = tuple(c[j] for c in cell)
                    fj = tuple(f[j] for f in frac)
                    idx, w = rt._scatter_corner_parts(cfg, cj, fj, ones)
                    vals = jnp.take(gpad_flat,
                                    jnp.tile(bid_off_pad, 8) + idx) * w
                    gs.append(vals.reshape(8, -1).sum(axis=0))
                g = jnp.stack(gs)               # (batch, N)
            gam = jnp.exp(jnp.clip(g * dsb, -GAIN_CLIP, GAIN_CLIP))
            gcum = jnp.cumprod(gam, axis=0)
            # exact termination: died_j = true gained energy at or below
            # the stop threshold; deposits masked from the step AFTER the
            # first death (the killing step still deposits — the lookup
            # order), intensity masked FROM the killing step (the lookup's
            # post-step alive mask)
            u_true = u_ng * gcum                # (batch, N)
            died = (u_true <= stop_frac_w * uinit_b).astype(dtype)
            anydied = jax.lax.cummax(died, axis=0)
            prev_any = jnp.concatenate(
                [jnp.zeros_like(anydied[:1]), anydied[:-1]])
            inc_c = inc * gcum * (1.0 - prev_any)
            mint = 1.0 - anydied
            for j in range(batch):
                cj = tuple(c[j] for c in cell)
                fj = tuple(f[j] for f in frac)
                if not edep_skip:
                    edep = rt._scatter_deposit(cfg, edep, cj, fj, inc_c[j])
                ibeams = deposit_intensity(ibeams, cj, fj,
                                           contrib0[j] * gcum[j] * mint[j])
            # frozen true energy: at the first death step, else the window
            # end
            uout = ((u_true * died * (1.0 - prev_any)).sum(axis=0)
                    + u_true[-1] * (1.0 - anydied[-1]))
            state = dataclasses.replace(
                state, uray=uout,
                alive=state.alive & (uout > stop_frac_w * state.uray_init))
            return (state, edep, ibeams, oflow), None

        def step(carry, _):
            state, edep, ibeams, oflow = carry
            state, ds = apply_gain(state)
            state, edep, of = base_step(state, edep, field4)
            # per-beam local-intensity deposit (trilinear, same corner
            # scheme as edep): uray * v/c -> W/cm^2 fields
            contrib = jnp.where(state.alive, state.uray * (ds * inv_cdt),
                                jnp.asarray(0.0, dtype))
            ibeams = deposit_intensity(ibeams, state.cell, state.frac,
                                       contrib)
            return (state, edep, ibeams, oflow + of), None

        def chunk_body(carry, steps_in_chunk):
            state, edep_master, imaster, oflow = carry
            edep0 = jnp.zeros(cfg.edep_shape, dtype)
            ib0 = jnp.zeros(imaster.shape, dtype)

            def run_inner(n_steps):
                if kernel_gain:
                    return jax.lax.scan(step_window,
                                        (state, edep0, ib0, oflow), None,
                                        length=n_steps // batch)[0]
                return jax.lax.scan(step, (state, edep0, ib0, oflow), None,
                                    length=n_steps)[0]

            def run_chunk():
                if last_chunk == chunk:
                    return run_inner(chunk)
                return jax.lax.cond(steps_in_chunk == chunk,
                                    lambda: run_inner(chunk),
                                    lambda: run_inner(last_chunk))

            state2, edep32, ib32, oflow = jax.lax.cond(
                jnp.any(state.alive), run_chunk,
                lambda: (state, edep0, ib0, oflow))
            return (state2, edep_master + edep32.astype(edep_master.dtype),
                    imaster + ib32, oflow), None

        # chunked accumulation (see raytracer.make_trace_fn): per-chunk
        # grids promote into wider masters, and fully-dead chunks are
        # skipped
        edep_master = jnp.zeros(cfg.edep_shape, rt.master_dtype(cfg))
        imaster = jnp.zeros((nb, hx + 2, hy + 2, hz + 2), dtype)
        steps_per_chunk = jnp.asarray(
            [chunk] * (n_chunks - 1) + [last_chunk], jnp.int32)
        (state, edep, ibeams, oflow), _ = jax.lax.scan(
            chunk_body, (state0, edep_master, imaster, jnp.int32(0)),
            steps_per_chunk)
        # crop ghosts -> per-beam node fields (B, Ph) on the CBET grid
        inodes = ibeams[:, 1:-1, 1:-1, 1:-1].reshape(nb, hx * hy * hz)
        return edep, inodes, state, oflow

    return trace


@dataclasses.dataclass
class _CbetSolver:
    """Everything a fixed-point CBET iteration reuses across ``cbet_solve``
    calls: the jitted gain/trace/update functions and the (device-resident,
    possibly sharded) padded ray state and beam ids.

    None of it depends on the iteration-control fields
    (``cbet_max_iters``/``cbet_tol``/``cbet_relax``/``cbet_accel``), so
    warm-up and measured solves share one instance via ``_SOLVER_CACHE``."""

    gain_fn: Any
    upsample: Any
    trace: Any                 # (field4, gain, bid, state0) -> checked outputs
    # edep-skipping variant for intermediate iterations (None when off):
    # identical state/intensity evolution, edep untouched
    trace_light: Any
    state0: rt.RayState
    bid: jnp.ndarray
    make_zero_gain: Any        # () -> (B, P) zeros; factory, not pinned memory
    # memoized zero-gain (iteration-0) intensity (Config.cbet_seed_zero_gain):
    # a pure function of (solver, state0) — the same device array iteration 0
    # recomputes on every solve.  Populated on first compute, reused after.
    seed_intensity: Any = None


# One fused dispatch per iteration for the convergence scalars + the
# under-relaxed update.  relax rides as an argument so one cached program
# serves every cbet_relax setting (the solver key normalizes it).
@jax.jit
def _step_update(i_new, i_old, relax):
    delta = jnp.max(jnp.abs(i_new - i_old))
    scale = jnp.max(jnp.abs(i_old))
    blended = relax * i_new + (1.0 - relax) * i_old
    return delta, scale, blended


# Anderson(m=1) mixing (Config.cbet_accel="anderson") — same one-fused-
# dispatch rule as _step_update.  _accel_first IS the plain relaxed step
# (bit-identical update), returned with the residual f_k to seed the secant
# history; _accel_next subtracts the least-squares secant correction
# gamma*(dx + relax*df).  The dot products run on the SCALE-NORMALIZED
# residuals (gamma is invariant under the common scaling, and raw intensity
# residuals squared overflow f32 at config-4 magnitudes); gamma is
# safeguarded: 0 on a degenerate secant, clipped to [-2, 2] (an uncorrected
# step is always the fallback — the plain damped iteration is known-
# convergent).
@jax.jit
def _accel_first(i_new, i_old, relax):
    f = i_new - i_old
    delta = jnp.max(jnp.abs(f))
    scale = jnp.max(jnp.abs(i_old))
    return delta, scale, i_old + relax * f, f


@jax.jit
def _accel_next(i_new, i_old, prev_x, prev_f, relax):
    f = i_new - i_old
    delta = jnp.max(jnp.abs(f))
    scale = jnp.max(jnp.abs(i_old))
    s = jnp.maximum(scale, jnp.finfo(f.dtype).tiny)
    fs = (f / s).ravel()
    dfs = ((f - prev_f) / s).ravel()
    den = jnp.vdot(dfs, dfs)
    gamma = jnp.where(den > 0,
                      jnp.vdot(fs, dfs) / jnp.maximum(den, jnp.finfo(
                          f.dtype).tiny), 0.0)
    gamma = jnp.clip(gamma, -2.0, 2.0).astype(f.dtype)
    x_next = (i_old + relax * f) - gamma * ((i_old - prev_x)
                                            + relax * (f - prev_f))
    return delta, scale, x_next, f


_SOLVER_CACHE: dict = {}
_SOLVER_CACHE_MAX = 3


def _get_solver(cfg: Config, ctx: rt.TraceContext, mesh) -> _CbetSolver:
    # mesh keyed by CONTENT (device ids + topology), not id(): a dead
    # mesh's id can be reused by a different one, silently resurrecting a
    # solver jitted over the wrong placement
    mesh_key = None if mesh is None else (
        mesh.axis_names, mesh.devices.shape,
        tuple(d.id for d in mesh.devices.flat))
    key = (cfg.replace(cbet_max_iters=1, cbet_tol=0.0, cbet_relax=0.5,
                       cbet_seed_zero_gain=True, cbet_accel="none"),
           mesh_key)
    # LRU on the insertion-ordered dict: pop-and-reinsert on hit refreshes
    # recency, and a same-key rebuild (new ctx) never evicts a different
    # entry
    hit = _SOLVER_CACHE.pop(key, None)
    if hit is not None and hit[0] is ctx:
        _SOLVER_CACHE[key] = hit
        return hit[1]
    solver = _build_solver(cfg, ctx, mesh)
    while len(_SOLVER_CACHE) >= _SOLVER_CACHE_MAX:
        _SOLVER_CACHE.pop(next(iter(_SOLVER_CACHE)))
    _SOLVER_CACHE[key] = (ctx, solver)
    return solver


def _build_solver(cfg: Config, ctx: rt.TraceContext, mesh) -> _CbetSolver:
    import math as _math

    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    from ..parallel.sharding import AXIS, pad_rays, put_state

    rpt = ctx.layout.rays_per_tile
    n_dev = 1 if mesh is None else int(_math.prod(mesh.devices.shape))
    if ctx.compact:
        # prepare_device contexts are born in exactly the beam-contiguous
        # live-tile layout this solve needs — no reselection
        state_raw = ctx.state0
        bid_raw = np.asarray(ctx.beam_id)
    else:
        # trace only launched tiles (~24% fewer slots on the OMEGA scene)
        slots = live_tile_slots(cfg, ctx)
        state_raw = rt.select_rays(ctx.state0, slots)
        bid_raw = np.asarray(ctx.beam_id)[slots]
    # per-slot beam ids (uncovered slots carry -1 -> 0; they never launch)
    bid_raw = np.maximum(bid_raw, 0).astype(np.int32)
    tpg = (state_raw.n // rpt) // cfg.nbeams

    state0 = pad_rays(state_raw, n_dev * rpt)
    bid = np.pad(bid_raw, (0, state0.n - bid_raw.shape[0]))
    # commit the per-ray arrays ONCE, in the layout the per-iteration jitted
    # trace consumes: single-device -> resident on the default device; mesh
    # -> sharded along the ray axis so every fixed-point iteration reuses
    # the resident shards
    if n_dev > 1:
        sharding = NamedSharding(mesh, Pspec(AXIS))
        state0 = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), sharding), state0)
        bid = jax.device_put(jnp.asarray(bid), sharding)
    else:
        state0 = put_state(state0)
        bid = jnp.asarray(bid)

    local = make_cbet_trace_fn(cfg, ctx, sharded=n_dev > 1,
                               tiles_per_group=tpg)
    if n_dev > 1:
        def sharded_trace(field4, gain, bid_, st):
            edep, inodes, st2, of = local(field4, gain, bid_, st)
            # per-shard full-(B,P) grids -> sum over shards
            return (jax.lax.psum(edep, AXIS), jax.lax.psum(inodes, AXIS),
                    st2, jax.lax.psum(of, AXIS))

        trace_j = jax.jit(jax.shard_map(
            sharded_trace, mesh=mesh,
            in_specs=(Pspec(), Pspec(), Pspec(AXIS), Pspec(AXIS)),
            out_specs=(Pspec(), Pspec(), Pspec(AXIS), Pspec()),
            check_vma=False))
    else:
        trace_j = jax.jit(local)

    def _checked(trace_j):
        def trace(field4, gain, bid_, st):
            """One gain-coupled trace + the lost-deposit check, fenced with
            a single scalar fetch."""
            edep, inodes, st2, of = trace_j(field4, gain, bid_, st)
            rt.check_overflow(int(jax.device_get(of)))
            return edep, inodes, st2
        return trace

    # LIGHT iteration trace (Config.cbet_light_iterations): same trace
    # with the edep scatter skipped — intermediate fixed-point iterations
    # discard edep, so the final full trace (same gain) reproduces it
    # identically (tested bit-equal).  Single-device.
    trace_light = None
    if cfg.cbet_light_iterations:
        if n_dev > 1:
            raise ValueError(
                "cbet_light_iterations=True is single-device only (mesh "
                "solves run full iterations)")
        trace_light = _checked(jax.jit(make_cbet_trace_fn(
            cfg, ctx, tiles_per_group=tpg, edep_skip=True)))

    # the per-step lookup table is always full-resolution; coarse gain
    # fields (cbet_grid_downsample > 1) are trilinearly upsampled once per
    # iteration rather than sampled at coarse nodes per step.  zero_gain
    # is a FACTORY: the (B, P) zeros are used once per solve (iteration
    # 0); pinning them in every cached solver would hold up to
    # _SOLVER_CACHE_MAX copies of pure zeros in device memory
    def make_zero_gain():
        return jnp.zeros((cfg.nbeams, cfg.nx * cfg.ny * cfg.nz),
                         jnp.dtype(cfg.dtype))

    upsample = (make_gain_upsampler(cfg) if cfg.cbet_grid_downsample > 1
                else (lambda g: g))
    return _CbetSolver(gain_fn=make_gain_fn(cfg, ctx), upsample=upsample,
                       trace=_checked(trace_j), trace_light=trace_light,
                       state0=state0, bid=bid,
                       make_zero_gain=make_zero_gain)


def cbet_solve(cfg: Config, ctx: rt.TraceContext, mesh=None,
               verbose: bool = False) -> CbetResult:
    """Fixed-point CBET solve (batched over beam pairs).

    With a multi-device ``mesh``, each iteration's trace is shard_mapped
    over the ray axis with psum-reduced deposition and intensity grids
    (BASELINE config 5 structure).

    The built solver (jitted trace, device-resident state) is cached
    across calls on everything but the iteration-control fields, so a
    1-iteration warm-up solve absorbs the build/compile cost and a
    subsequent measured solve starts iterating immediately."""
    import time as _time

    solver = _get_solver(cfg, ctx, mesh)
    state0, bid = solver.state0, solver.bid
    hx, hy, hz = cfg.cbet_grid_shape
    nb = cfg.nbeams

    gain_dtype = jnp.dtype(cfg.dtype)
    # light iterations (solver.trace_light): every fixed-point iteration
    # skips the edep scatter it would discard; ONE full trace with the
    # final iteration's gain reproduces edep identically afterwards
    tr_it = solver.trace_light or solver.trace
    gain_last = solver.make_zero_gain()
    # iteration 0 (zero gain) is a pure function of (solver, state0):
    # reuse the memoized intensity when the flag allows (bit-identical to
    # recomputing — Config.cbet_seed_zero_gain).  edep/state placeholders
    # are overwritten by the first loop iteration (max_iters >= 1 there).
    seed_ok = cfg.cbet_seed_zero_gain and cfg.cbet_max_iters >= 1
    seeded = seed_ok and solver.seed_intensity is not None
    _t0 = _time.perf_counter()
    if seeded:
        intensity = solver.seed_intensity
        edep = state = None
    else:
        edep, intensity, state = tr_it(ctx.field4, gain_last, bid, state0)
        if seed_ok:
            solver.seed_intensity = intensity
    iter0_seconds = _time.perf_counter() - _t0
    history = []
    iter_seconds = []          # per-iteration wall (fenced by the float()
    #                            materialization of the convergence scalar)
    converged = False
    it = 0

    accel = cfg.cbet_accel == "anderson"
    prev_x = prev_f = None
    for it in range(1, cfg.cbet_max_iters + 1):
        _t0 = _time.perf_counter()
        gain = solver.upsample(solver.gain_fn(intensity)).astype(gain_dtype)
        if verbose:
            # fence: dispatch is async — without it the gain bucket below
            # would time only dispatch and the gain's compute would land in
            # the trace bucket
            gain.block_until_ready()
        _t1 = _time.perf_counter()
        gain_last = gain
        edep, i_new, state = tr_it(ctx.field4, gain, bid, state0)
        _t2 = _time.perf_counter()
        if not accel:
            d_dev, s_dev, blended = _step_update(
                i_new, intensity, float(cfg.cbet_relax))
        elif prev_f is None:
            d_dev, s_dev, blended, f_cur = _accel_first(
                i_new, intensity, float(cfg.cbet_relax))
        else:
            d_dev, s_dev, blended, f_cur = _accel_next(
                i_new, intensity, prev_x, prev_f, float(cfg.cbet_relax))
        delta = float(d_dev) / max(float(s_dev), 1e-300)
        _t3 = _time.perf_counter()
        history.append(delta)
        iter_seconds.append(round(_t3 - _t0, 3))
        if verbose:
            print(f"cbet iter {it}: rel delta {delta:.3e} "
                  f"[gain {_t1 - _t0:.2f}s trace {_t2 - _t1:.2f}s "
                  f"update {_t3 - _t2:.2f}s]", flush=True)
        if delta < cfg.cbet_tol:
            intensity = i_new
            converged = True
            break
        if accel:
            # the secant history: x_k (the pre-update iterate) and its
            # residual — python references, no device copies
            prev_x, prev_f = intensity, f_cur
        intensity = blended

    if solver.trace_light is not None:
        # the final full trace: same gain as the last executed iteration ->
        # identical edep/state/intensity to the non-light solve
        edep, _, state = solver.trace(ctx.field4, gain_last, bid, state0)

    # result materialization: the converged fields + final ray state leave
    # the device here (~250 MB at OMEGA scale), timed separately in stats
    _tf = _time.perf_counter()
    stats = rt.trace_stats(ctx, state, state0)
    edep_h = np.asarray(jax.device_get(edep), np.float64)
    inten_h = np.asarray(jax.device_get(intensity), np.float64).reshape(
        nb, hx, hy, hz)
    stats["result_fetch_seconds"] = round(_time.perf_counter() - _tf, 3)
    stats["light_iterations"] = solver.trace_light is not None
    stats["gain_mode"] = cfg.cbet_gain_mode
    stats["gain_rows2"] = cfg.cbet_gain_rows2
    stats["relax"] = cfg.cbet_relax
    stats["accel"] = cfg.cbet_accel
    # per-iteration wall clocks: each is fenced by the host materialization
    # of the convergence scalar, so iteration 1 also absorbs iteration 0's
    # async-dispatched compute (iter0_seconds is dispatch-only unless
    # seeded)
    stats["iter_seconds"] = iter_seconds
    stats["iter0_seconds"] = round(iter0_seconds, 3)
    stats["seeded_zero_gain"] = bool(seeded)
    return CbetResult(
        edep=edep_h, intensity=inten_h,
        iterations=it, converged=converged, history=history, stats=stats)
