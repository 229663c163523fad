"""Precomputed 3-D node fields — the core design move of the step.

The reference's hot loop performs 8 binary-search radial interpolations per
ray per step (``launch_ray_XZ.cu:254-265,296-298``) — but every one of those
lookups is evaluated at grid *node* coordinates (``thisx*dx+xmin`` etc.), so
the full set of possible arguments is the static set of node radii.  We
therefore precompute, once:

* ``eden``  — electron density at every node,
* ``etemp`` — electron temperature at every node,
* ``fgrad`` — the pre-scaled central-difference density-gradient velocity
  kick per step (``xconst*(eden_xp - eden_xm)`` etc., main.cu:156-159 and
  launch_ray_XZ.cu:212-270), with the reference's one-sided edge stencils,
* ``absorb`` — the per-step fractional energy absorption coefficient
  (``ed/ncrit * nuei * dt``, launch_ray_XZ.cu:296-305),
* ``wsq_term`` — the plasma-frequency term of the dispersion relation used
  once per ray at launch (launch_ray_XZ.cu:186-188).

The integrator's inner loop then reduces to two gathers, ~30 flops, and one
8-corner scatter-add per ray-step — no search, no interpolation.  The
precompute itself is exact: piecewise-linear interpolation evaluated at node
radii gives bit-identical values to interpolating on demand.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as k
from .config import Config
from .ops.interp import interp
from .profiles import RadialProfiles


def np_interp_table(y: np.ndarray, x: np.ndarray, xp: np.ndarray) -> np.ndarray:
    """Piecewise-linear interp with the reference's clamping semantics
    (launch_ray_XZ.cu:16-63); NumPy inputs stay float64 NumPy."""
    return interp(y, x, xp)


@dataclasses.dataclass(frozen=True)
class Fields:
    """Precomputed node fields (float64 NumPy, shapes (nx, ny, nz[, 3]))."""

    eden: np.ndarray       # electron density [cm^-3]
    etemp: np.ndarray      # electron temperature [eV]
    fgrad: np.ndarray      # (nx, ny, nz, 3) velocity kick per step [cm/s]
    absorb: np.ndarray     # fractional energy loss per step (dimensionless)
    wsq_term: np.ndarray   # omega_pe^2 / c^2 term at nodes [cm^-2]

    @property
    def shape(self):
        return self.eden.shape


class CachedFields:
    """Field set restored from the prepare cache: only ``eden`` was
    persisted (all any downstream consumer needs today — CBET's gain
    prefactor).  Accessing any other field fails loudly AT THE POINT OF USE
    instead of handing out ``None`` that blows up far from the cause."""

    __slots__ = ("eden",)

    def __init__(self, eden: np.ndarray):
        self.eden = eden

    def __getattr__(self, name):
        if name in ("etemp", "fgrad", "absorb", "wsq_term"):
            raise AttributeError(
                f"Fields.{name} is not available on a cache-loaded context "
                "(the prepare cache persists only eden) — re-run "
                "prepare() without cache_dir, or bump "
                "raytracer.PREP_CACHE_VERSION and persist the field")
        raise AttributeError(name)

    @property
    def shape(self):
        return self.eden.shape


def node_radii(cfg: Config) -> np.ndarray:
    x = np.arange(cfg.nx) * cfg.dx + cfg.xmin
    y = np.arange(cfg.ny) * cfg.dy + cfg.ymin
    z = np.arange(cfg.nz) * cfg.dz + cfg.zmin
    return np.sqrt(x[:, None, None] ** 2 + y[None, :, None] ** 2 + z[None, None, :] ** 2)


def _edge_stencil(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Plus/minus stencil indices per the reference's wall clamping
    (launch_ray_XZ.cu:212-238): interior (i-1, i+1); at i=0 -> (0, 2);
    at i=n-1 -> (n-3, n-1)."""
    if n < 3:
        # the reference's wall stencil reads i=2 and n-3; fail at the
        # source instead of an opaque out-of-bounds deep in build_fields
        raise ValueError(f"grid axes must have >= 3 nodes, got {n}")
    i = np.arange(n)
    p = np.minimum(i + 1, n - 1)
    m = np.maximum(i - 1, 0)
    p[0] = 2
    m[n - 1] = n - 3
    return m, p


def build_fields(cfg: Config, prof: RadialProfiles) -> Fields:
    r = node_radii(cfg)
    eden = np_interp_table(prof.ne, prof.r, r)
    etemp = np_interp_table(prof.te, prof.r, r)

    xm, xp = _edge_stencil(cfg.nx)
    ym, yp = _edge_stencil(cfg.ny)
    zm, zp = _edge_stencil(cfg.nz)
    fgrad = np.stack(
        [
            cfg.dedx_const * (eden[xp, :, :] - eden[xm, :, :]),
            cfg.dedy_const * (eden[:, yp, :] - eden[:, ym, :]),
            cfg.dedz_const * (eden[:, :, zp] - eden[:, :, zm]),
        ],
        axis=-1,
    )

    # Spitzer-type resistivity and e-i collision frequency
    # (launch_ray_XZ.cu:299-300).  The reference hard-codes 10.0, not Z=3.1.
    eta = k.ETA_COEF * cfg.eta_z_factor / (etemp * np.sqrt(etemp))
    nuei = (1e6 * eden * k.EC ** 2 / k.ME_KG) * eta
    absorb = eden / k.NCRIT * nuei * cfg.dt

    wsq_term = eden * 1e6 * (k.EC ** 2) / (k.ME_KG * k.E0)

    return Fields(eden=eden, etemp=etemp, fgrad=fgrad, absorb=absorb, wsq_term=wsq_term)
