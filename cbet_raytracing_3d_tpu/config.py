"""Runtime configuration for the CBET ray tracer.

Everything the reference fixes at compile time through the preprocessor
(``/root/reference/def.cuh:25-131``) is a runtime field here, with identical
derived-quantity formulas.  A frozen dataclass keeps configs hashable so they
can be closed over by ``jax.jit``-compiled functions.

Two behavioral modes:

* ``parity="clean"`` (default): all ``nrays`` rays per beam are traced.
* ``parity="reference"``: reproduces the reference's silent truncation of
  rays — the CUDA launch grid uses ``threads_per_beam // threads_per_block``
  blocks, dropping ``nrays % 256`` (=144) rays per beam
  (``main.cu:161``, ``def.cuh:127-129``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from . import constants as k


@dataclasses.dataclass(frozen=True)
class Config:
    # --- grid (def.cuh:33-53) ---
    nx: int = 100
    ny: int = 100
    nz: int = 100
    xmin: float = -0.13
    xmax: float = 0.13
    ymin: float = -0.13
    ymax: float = 0.13
    zmin: float = -0.13
    zmax: float = 0.13
    nr: int = 443                     # radial profile table length (def.cuh:33)

    # --- beams / rays (def.cuh:55-58, 71-78, 89-92, 119) ---
    nbeams: int = 60
    beam_min_x: float = -450.0e-4
    beam_max_x: float = 450.0e-4
    rays_per_zone: int = 4
    sigma: float = 0.0375             # super-Gaussian width of beam power
    intensity: float = 1.0e14         # beam intensity [W/cm^2]
    focal_length: float = 0.1
    offset: float = 0.5e-4            # unused by the reference kernel; kept for parity

    # --- time stepping (def.cuh:80-87) ---
    courant_mult: float = 0.5

    # --- physics toggles (def.cuh:118; launch_ray_XZ.cu:299-311) ---
    absorption: bool = True
    # The reference hard-codes 10.0 in eta instead of Z=3.1
    # (launch_ray_XZ.cu:299 vs def.cuh:100); override here if desired.
    eta_z_factor: float = k.ETA_Z_FACTOR
    # termination threshold: ray stops below this fraction of initial energy
    # (launch_ray_XZ.cu:351)
    stop_fraction: float = 0.05
    # cell-search tolerance "half" (launch_ray_XZ.cu:132, 164)
    cell_tol: float = 0.5001

    # --- power-profile table (main.cu:102-110) ---
    pow_table_len: int = 2001
    pow_table_max: float = 0.1

    # --- CBET stage (def.cuh:94-114; not implemented by the reference) ---
    cbet_max_iters: int = 30
    # convergence: max relative intensity-field change between iterations.
    # 5e-3 converges the 60-beam OMEGA solve once the field change is ~100x
    # below the physical 0.3-0.5 first-iteration redistribution; tighten
    # for studies.
    cbet_tol: float = 5e-3
    # Under-relaxation of the intensity-field update.  The fixed point is
    # relax-independent (tests/test_cbet.py::test_cbet_relax_invariant_
    # fixed_point); the coupling map is strongly contractive at OMEGA
    # intensities, so damping only adds iterations.  0.9 keeps a damping
    # margin for stronger-coupling scenes; oscillation shows up as
    # non-monotone res.history / converged=False, never silently.
    cbet_relax: float = 0.9
    # Fixed-point acceleration of the intensity update.  "anderson" is
    # Anderson mixing with depth 1 (a field-level secant step on the
    # residual f_k = G(x_k) - x_k, mixing parameter = cbet_relax): the
    # first update is exactly the plain relaxed step, later updates
    # subtract gamma*(dx_k + relax*df_k) with gamma the least-squares
    # coefficient <f_k, df_k>/<df_k, df_k>, safeguarded (gamma -> 0 on a
    # degenerate secant, clipped to [-2, 2]).  Same map, same fixed point
    # (test_cbet_accel_anderson_fixed_point).  Costs 2 extra
    # intensity-field buffers of device memory; opt-in for tight-tolerance
    # studies.
    cbet_accel: Literal["none", "anderson"] = "none"
    machnum: float = k.MACH           # flow Mach number (def.cuh:99; machnum undefined there)
    ncrossings_mult: int = 3          # ncrossings = mult*nx (def.cuh:96)
    # CBET gain application model:
    # * "lookup": per-step nearest-node gain-table lookup at the ray's
    #   step-entry cell (one gather per step from the (B, P) table).
    # * "kernel": TRILINEAR gain at every step's deposit position, applied
    #   per deposit window of ``deposit_batch_steps`` steps: the window
    #   advances gain-free, and the per-step factors are cumulative-
    #   multiplied onto its deposits, intensity contributions and ray
    #   energies afterwards — exact by multiplicative separability of gain
    #   and absorption, with the EXACT termination rule applied from the
    #   true gained energy.  The trilinear sampling position (vs the
    #   lookup's entry-cell node) is the mode's only model deviation.
    # * "kernel_cell": the window form with the LOOKUP mode's exact
    #   sampling — single-node gain at each step's ENTRY cell.  With the
    #   exact termination rule this mode is IDENTICAL to the per-step
    #   lookup on every parity-bearing output (edep, intensity, uray,
    #   alive — tested to ~1e-12 in f64); only the positions/velocities of
    #   mid-window energy-dead rays differ (frozen at the window end
    #   instead of the death step), which no output depends on.
    # The window modes need deposit_batch_steps > 1 dividing the chunk
    # lengths.
    cbet_gain_mode: Literal["lookup", "kernel", "kernel_cell"] = "lookup"
    # Per-beam-sliced gain-table gathers: the single-device CBET ray layout
    # is beam-contiguous, so each beam's slots gather from its OWN (P,)
    # gain row instead of the full (B, P) table.  Values are identical
    # (same elements, sliced); mesh solves use the flat beam-offset gather.
    cbet_gain_sliced: bool = True
    # Pad the sliced per-beam gain rows to 2-wide (value duplicated).
    # None = auto: enabled when the duplicated table stays under ~1.5 GB
    # (on at OMEGA's 480 MB, off at the 3.9 GB config-4 table).  Values
    # are identical either way.
    cbet_gain_rows2: bool | None = None
    # LIGHT fixed-point iterations: intermediate CBET iterations discard
    # their edep grid (each iteration's trace overwrites it; only the
    # final one is the answer), so the window gain modes can skip the edep
    # scatter.  After convergence, ONE extra full trace with the same gain
    # the final iteration used produces edep — the results are IDENTICAL
    # to the non-light solve (same gain -> same trace; tested bit-equal).
    # None/False = off; True requires a window gain mode ("kernel" or
    # "kernel_cell") on a single device and errors loud otherwise.
    cbet_light_iterations: bool | None = None
    # Iteration-0 reuse: the fixed-point solve's first trace runs at zero
    # gain, so its intensity output is a pure function of (solver, state0)
    # — identical bits on every solve of the same cached solver.  With this
    # flag the solver memoizes that zero-gain intensity on first compute
    # and every later solve starts the iteration from the memo, skipping
    # one full trace.  EXACT, not an approximation: the seed is the same
    # device array iteration 0 would produce.  Costs one resident
    # (B, P_coarse) f32 intensity per cached solver (~240 MB at OMEGA
    # scale, counted by the device-memory preflight).
    cbet_seed_zero_gain: bool = True
    # CBET intensity/gain grid coarsening: 1 evaluates the per-beam intensity
    # fields and gain on the full node grid; s>1 uses an s-times-coarser node
    # grid (nodes at full-grid indices 0, s, 2s, ...).  The gain fields are
    # smooth (ion-acoustic response x beam envelopes), so coarsening trades
    # a small model perturbation for s^3-fold cheaper per-iteration gain
    # evaluation and intensity deposition.  The coupled edep stays
    # full-resolution either way.
    cbet_grid_downsample: int = 1

    # --- execution ---
    parity: Literal["clean", "reference"] = "clean"
    dtype: Literal["float32", "float64"] = "float32"
    edep_dtype: Literal["float32", "float64"] = "float64"
    chunk_steps: int = 25             # scan-chunk length for f32->f64 promotion
    # Launch-tile edge in zones (4 -> 256 rays/tile at OMEGA): rays are
    # ordered tile-major so consecutive rays stay spatially coherent
    # through the whole trace.
    tile_zones: int = 4
    # Deposit-window length of the window gain modes (cbet_gain_mode
    # "kernel"/"kernel_cell"): the window mini-scan advances this many
    # steps before the window's gain factors are applied.
    deposit_batch_steps: int = 5

    # ===== derived quantities (formulas identical to def.cuh) =====
    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / (self.nx - 1)

    @property
    def dy(self) -> float:
        return (self.ymax - self.ymin) / (self.ny - 1)

    @property
    def dz(self) -> float:
        return (self.zmax - self.zmin) / (self.nz - 1)

    @property
    def nrays_x(self) -> int:
        # def.cuh:75
        return int(self.rays_per_zone * math.ceil((self.beam_max_x - self.beam_min_x) / self.dx))

    @property
    def nrays_y(self) -> int:
        # def.cuh:76
        return int(self.rays_per_zone * math.ceil((self.beam_max_x - self.beam_min_x) / self.dy))

    @property
    def nrays(self) -> int:
        return self.nrays_x * self.nrays_y

    @property
    def zones_spanned(self) -> int:
        # launch_ray_XZ.cu:69
        return int(math.ceil((self.beam_max_x - self.beam_min_x) / self.dx))

    @property
    def dt(self) -> float:
        # def.cuh:81
        return self.courant_mult * min(self.dx, self.dz) / k.C_CMS

    @property
    def nt(self) -> int:
        # def.cuh:83-87
        return int((1.0 / self.courant_mult) * max(self.nx, self.nz) * 2.0)

    @property
    def uray_mult(self) -> float:
        # def.cuh:92
        return self.intensity * self.courant_mult / float(self.rays_per_zone ** 2)

    @property
    def ncrossings(self) -> int:
        # def.cuh:96
        return self.ncrossings_mult * self.nx

    @property
    def numstored(self) -> int:
        # per-cell crossing capacity contract (def.cuh:94)
        return 5 * self.rays_per_zone

    @property
    def traced_rays_per_beam(self) -> int:
        """Rays actually traced per beam.

        ``parity="reference"`` reproduces the launch-grid truncation: only
        ``(nrays // 256) * 256`` threads are launched per beam
        (main.cu:161, def.cuh:127-129).
        """
        if self.parity == "reference":
            return (self.nrays // 256) * 256
        return self.nrays

    @property
    def grad_const(self) -> float:
        # main.cu:156
        return (k.C_CMS ** 2) / (2.0 * k.NCRIT) * self.dt * 0.5

    @property
    def dedx_const(self) -> float:
        return self.grad_const / self.dx

    @property
    def dedy_const(self) -> float:
        return self.grad_const / self.dy

    @property
    def dedz_const(self) -> float:
        return self.grad_const / self.dz

    @property
    def cbet_grid_shape(self) -> tuple:
        """Node counts of the (possibly coarsened) CBET intensity/gain grid:
        ceil(n/s) nodes cover full-grid node indices 0, s, ..., exactly the
        stride-``s`` subsample of the full node grid."""
        s = self.cbet_grid_downsample
        return (-(-self.nx // s), -(-self.ny // s), -(-self.nz // s))

    @property
    def edep_shape(self) -> tuple:
        # node-centered grid with one ghost layer per side (def.cuh:131)
        return (self.nx + 2, self.ny + 2, self.nz + 2)

    @property
    def total_rays(self) -> int:
        return self.nbeams * self.nrays

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def small_test_config(**kw) -> Config:
    """A shrunken config for fast tests: one beam, few rays, coarse grid."""
    defaults = dict(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40, dtype="float64")
    defaults.update(kw)
    return Config(**defaults)
