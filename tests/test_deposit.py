"""Deposition tests: the XLA scatter deposit vs a literal transcription of
the reference corner scheme (launch_ray_XZ.cu:319-348), dead rays, boundary
exit rows, a high-resolution grid, and energy conservation."""

import jax.numpy as jnp
import numpy as np

from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models.raytracer import _scatter_deposit

CFG = Config(nx=24, ny=20, nz=22)
GRID = (CFG.nx, CFG.ny, CFG.nz)
SHAPE3 = CFG.edep_shape


def _random_rays(rng, n, cell_lo=(0, 0, 0), cell_hi=GRID):
    cell = [rng.integers(cell_lo[a], cell_hi[a], size=n).astype(np.int32)
            for a in range(3)]
    frac = [rng.uniform(-0.4999, 0.4999, size=n) for _ in range(3)]
    inc = rng.uniform(0.5, 2.0, size=n)
    return cell, frac, inc


def _reference_deposit(cell, frac, inc):
    """Literal a1..a8 transcription."""
    want = np.zeros(SHAPE3)
    for i in range(len(inc)):
        cx, cy, cz = (cell[0][i], cell[1][i], cell[2][i])
        xp, yp, zp = (frac[0][i] - 0.5, frac[1][i] - 0.5, frac[2][i] - 0.5)
        dm, dn, dl = 1 - abs(xp), 1 - abs(yp), 1 - abs(zp)
        sx, sy, sz = (-1 if xp < 0 else 1), (-1 if yp < 0 else 1), (-1 if zp < 0 else 1)
        u = inc[i]
        want[cx + 1, cy + 1, cz + 1] += (1 - dl) * (1 - dn) * (1 - dm) * u
        want[cx + 1 + sx, cy + 1, cz + 1] += (1 - dl) * (1 - dn) * dm * u
        want[cx + 1, cy + 1, cz + 1 + sz] += dl * (1 - dn) * (1 - dm) * u
        want[cx + 1 + sx, cy + 1, cz + 1 + sz] += dl * (1 - dn) * dm * u
        want[cx + 1, cy + 1 + sy, cz + 1] += (1 - dl) * dn * (1 - dm) * u
        want[cx + 1 + sx, cy + 1 + sy, cz + 1] += (1 - dl) * dn * dm * u
        want[cx + 1, cy + 1 + sy, cz + 1 + sz] += dl * dn * (1 - dm) * u
        want[cx + 1 + sx, cy + 1 + sy, cz + 1 + sz] += dl * dn * dm * u
    return want


def _run_scatter(cell, frac, inc):
    got = _scatter_deposit(
        CFG, jnp.zeros(SHAPE3),
        tuple(jnp.asarray(c) for c in cell),
        tuple(jnp.asarray(f) for f in frac),
        jnp.asarray(inc))
    return np.asarray(got)


def test_scatter_matches_reference_formula(rng):
    cell, frac, inc = _random_rays(rng, 200)
    got = _run_scatter(cell, frac, inc)
    np.testing.assert_allclose(got, _reference_deposit(cell, frac, inc),
                               rtol=1e-12, atol=1e-12)


def test_scatter_energy_conservation(rng):
    cell, frac, inc = _random_rays(rng, 300)
    got = _run_scatter(cell, frac, inc)
    np.testing.assert_allclose(got.sum(), inc.sum(), rtol=1e-12)


def test_scatter_dead_rays_ignored(rng):
    """inc==0 rays must not affect the deposit, even with garbage
    (far-away) cells."""
    n = 64
    cell, frac, inc = _random_rays(rng, n, cell_lo=(5, 5, 5),
                                   cell_hi=(13, 13, 13))
    poison = np.arange(n) % 2 == 0
    for a in range(3):
        cell[a] = np.where(poison, GRID[a] - 1, cell[a]).astype(np.int32)
    inc = np.where(poison, 0.0, inc)
    got = _run_scatter(cell, frac, inc)
    keep = ~poison
    want = _run_scatter([c[keep] for c in cell], [f[keep] for f in frac],
                        inc[keep])
    np.testing.assert_array_equal(got, want)


def test_scatter_all_dead_tile(rng):
    cell, frac, inc = _random_rays(rng, 64)
    inc[:] = 0.0
    assert _run_scatter(cell, frac, inc).sum() == 0.0


def _boundary_rays(rng, n):
    """Rays near the LOW grid faces with boundary exit rows mixed in: a
    ray's final step can leave frac beyond +-0.5 (the re-index clamps the
    cell at a face while the position moves past it), so d = 1-|frac-0.5|
    goes NEGATIVE and the reference extrapolates one negative weight into
    the ghost layer (launch_ray_XZ.cu:319-348; deposit precedes the
    out-of-box break at :351-356)."""
    cell, frac, inc = _random_rays(rng, n, cell_lo=(0, 0, 0), cell_hi=(8, 8, 8))
    exit_rows = rng.permutation(n)[:n // 3]
    for a in range(3):
        rows = exit_rows[a::3]
        cell[a][rows] = 0
        frac[a][rows] = rng.uniform(-0.95, -0.55, size=rows.size)
    return cell, frac, inc


def test_scatter_boundary_exit_matches_reference(rng):
    """Boundary exit steps: the scatter deposit reproduces the reference's
    literal extrapolated weights (one NEGATIVE ghost-layer weight per
    out-of-range axis) exactly — conserved and correctly placed."""
    cell, frac, inc = _boundary_rays(rng, 64)
    got = _run_scatter(cell, frac, inc)
    want = _reference_deposit(cell, frac, inc)
    assert want.min() < 0  # the scene really has extrapolated rows
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.sum(), inc.sum(), rtol=1e-12)


def test_scatter_high_res_grid_matches_reference(rng):
    """BASELINE config 4's 200^3 grid (202^3 with ghosts): flat indices
    beyond 2^23 and deposits spread over the whole grid still match the
    literal corner formula."""
    cfg = Config(nx=200, ny=200, nz=200)
    shape = cfg.edep_shape
    n = 300
    cell = [rng.integers(0, 200, size=n).astype(np.int32) for _ in range(3)]
    frac = [rng.uniform(-0.4999, 0.4999, size=n) for _ in range(3)]
    inc = rng.uniform(0.5, 2.0, size=n)
    got = np.asarray(_scatter_deposit(
        cfg, jnp.zeros(shape), tuple(jnp.asarray(c) for c in cell),
        tuple(jnp.asarray(f) for f in frac), jnp.asarray(inc)))
    want = np.zeros(shape)
    for i in range(n):
        c = [int(cell[a][i]) + 1 for a in range(3)]
        p = [frac[a][i] - 0.5 for a in range(3)]
        d = [1 - abs(pp) for pp in p]
        sg = [-1 if pp < 0 else 1 for pp in p]
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    w = ((d[0] if ox else 1 - d[0]) * (d[1] if oy else 1 - d[1])
                         * (d[2] if oz else 1 - d[2]))
                    want[c[0] + ox * sg[0], c[1] + oy * sg[1],
                         c[2] + oz * sg[2]] += w * inc[i]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
