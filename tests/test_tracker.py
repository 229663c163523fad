"""Ray-tracker / crossing diagnostics vs the float64 oracle.

The reference's RAY_TRACKER_DIAGNOSTICS / INTERSECTION_DIAGNOSTICS hooks
(def.cuh:26-27) have no implementation to compare against; the contract
tested here is oracle.trace_ray's recorded path (the literal transcription
of the ray loop) and the def.cuh:96 ncrossings capacity bound.
"""

import os

import numpy as np
import pytest

from cbet_raytracing_3d_tpu.beams import load_beam_norms, power_table
from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models import raytracer as rt
from cbet_raytracing_3d_tpu.models.tracker import (RayTrajectories,
                                                   track_rays)

# a pupil-center ray, an oblique one, and a pupil-REJECTED thread id
# (ray 0 of the 140x140 launch lattice sits at the corner, radius ~636 um
# > beam_max_x=450 um)
BEAMS = [0, 17, 3]
RAYS = [9800, 4321, 0]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ctx64(profiles):
    return rt.prepare(Config(dtype="float64"), profiles)


@pytest.fixture(scope="module")
def traj(ctx64):
    return track_rays(ctx64.cfg, BEAMS, RAYS, ctx=ctx64)


def _oracle_path(ctx, beam, ray):
    from cbet_raytracing_3d_tpu.oracle import trace_ray
    cfg = ctx.cfg
    pow_r = power_table(cfg)
    phase_r = np.linspace(0.0, cfg.pow_table_max, cfg.pow_table_len)
    edep = np.zeros((cfg.nx + 2, cfg.ny + 2, cfg.nz + 2))
    return trace_ray(cfg, ctx.prof, load_beam_norms(nbeams=cfg.nbeams),
                     pow_r, phase_r, beam, ray, edep, record_path=True)


def test_paths_match_oracle(ctx64, traj):
    for i, (b, r) in enumerate(zip(BEAMS, RAYS)):
        ref = _oracle_path(ctx64, b, r)
        got = traj.path(i)
        assert len(got) == len(ref), (b, r)
        for t, (g, o) in enumerate(zip(got, ref)):
            assert g[:3] == o[:3], (b, r, t)          # cells exact
            np.testing.assert_allclose(g[3:6], o[3:6], rtol=0, atol=1e-12)
            np.testing.assert_allclose(g[6], o[6], rtol=1e-12)


def test_pupil_rejected_ray_records_nothing(traj):
    i = RAYS.index(0)
    assert not traj.launched[i]
    assert traj.steps[i] == 0
    assert traj.path(i) == []
    steps, cells = traj.crossings(i)
    assert steps.shape == (0,) and cells.shape == (0, 3)


def test_crossings_bounded_and_adjacent(ctx64, traj):
    cfg = ctx64.cfg
    counts = traj.crossing_counts()
    assert counts[traj.launched].min() >= 1
    # the reference sizes its crossing store at ncrossings = 3*nx per ray
    # (def.cuh:96) — any in-box trajectory must fit
    assert counts.max() <= cfg.ncrossings
    for i in range(traj.n):
        steps, cells = traj.crossings(i)
        if cells.shape[0] < 2:
            continue
        # the re-index loop moves at most 1 cell/axis/step
        # (launch_ray_XZ.cu:276-292, courant_mult bounds the CFL)
        assert np.abs(np.diff(cells, axis=0)).max() <= 1
        assert (np.diff(steps) >= 1).all()


def test_energy_monotone_and_terminal(ctx64, traj):
    cfg = ctx64.cfg
    for i in range(traj.n):
        p = traj.path(i)
        if not p:
            continue
        u = np.array([e[6] for e in p])
        assert (np.diff(u) <= 0).all()            # absorption only drains
        if traj.steps[i] < cfg.nt:                # terminated in-box or <5%
            x, y, z = p[-1][3:6]
            out = (u[-1] <= cfg.stop_fraction * traj.uray_init[i]
                   or x < cfg.xmin - cfg.dx / 2 or x > cfg.xmax + cfg.dx / 2
                   or y < cfg.ymin - cfg.dy / 2 or y > cfg.ymax + cfg.dy / 2
                   or z < cfg.zmin - cfg.dz / 2 or z > cfg.zmax + cfg.dz / 2)
            assert out, i


def test_npz_roundtrip(tmp_path, traj):
    f = str(tmp_path / "traj.npz")
    traj.save_npz(f)
    back = RayTrajectories.load_npz(f)
    np.testing.assert_array_equal(back.cell, traj.cell)
    np.testing.assert_array_equal(back.recorded, traj.recorded)
    np.testing.assert_allclose(back.uray, traj.uray)


def test_rejects_bad_ids(ctx64):
    with pytest.raises(ValueError):
        track_rays(ctx64.cfg, [0], [ctx64.cfg.nrays], ctx=ctx64)
    with pytest.raises(ValueError):
        track_rays(ctx64.cfg, [ctx64.cfg.nbeams], [0], ctx=ctx64)
    with pytest.raises(ValueError):
        track_rays(ctx64.cfg, [0, 1], [0], ctx=ctx64)


def test_rejects_mismatched_cfg(ctx64):
    """A (cfg, ctx) pair from different configs would read field4/slot maps
    with the wrong strides — jnp.take clamps under jit, so without this
    guard the mismatch records silently-wrong trajectories, not a crash."""
    other = ctx64.cfg.replace(rays_per_zone=2)
    with pytest.raises(ValueError, match="ctx.cfg"):
        track_rays(other, [0], [0], ctx=ctx64)


@pytest.mark.slow
def test_cli_track(tmp_path):
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out_npz = str(tmp_path / "traj.npz")
    out = subprocess.run(
        [sys.executable, "-m", "cbet_raytracing_3d_tpu.cli", "track",
         "--nbeams", "2", "--rays-per-zone", "2", "--nx", "32", "--ny", "32",
         "--nz", "32", "--pairs", "0:242,1:243", "--out", out_npz],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout)
    assert summary["rays"] == 2
    back = RayTrajectories.load_npz(out_npz)
    assert back.n == 2
    assert (back.steps == np.array(summary["steps"])).all()


@pytest.mark.slow
def test_cli_track_rejects_bad_pairs():
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "cbet_raytracing_3d_tpu.cli", "track",
         "--pairs", "0-3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 2
    assert "beam:ray" in out.stderr
    # out-of-range ids take the same clean error path (exit 2, one-line
    # message), not an uncaught ValueError traceback
    out = subprocess.run(
        [sys.executable, "-m", "cbet_raytracing_3d_tpu.cli", "track",
         "--pairs", "99:0"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 2
    assert "out of range" in out.stderr
    assert "Traceback" not in out.stderr


def test_slots_of_rays_matches_slot_of(ctx64):
    """The closed-form slot formula must reproduce the O(nbeams*nrays)
    slot_of map exactly (it replaced the map on the track path)."""
    cfg = ctx64.cfg
    rng = np.random.default_rng(7)
    beams = rng.integers(0, cfg.nbeams, 200).astype(np.int64)
    rays = rng.integers(0, cfg.nrays, 200).astype(np.int64)
    gtile, rit = rt.slots_of_rays(cfg, beams, rays)
    slots = gtile * ctx64.layout.rays_per_tile + rit
    np.testing.assert_array_equal(slots, ctx64.layout.slot_of[beams, rays])


def test_track_compact_context_matches_host(ctx64, profiles):
    """track_rays on a prepare_device (compact) context must reproduce the
    host-context trajectories — the compact layout's slots are derived in
    closed form through the deterministic traced tile order."""
    cfg = ctx64.cfg
    ctx_dev = rt.prepare_device(cfg, profiles)
    t_host = track_rays(cfg, BEAMS, RAYS, ctx=ctx64)
    t_dev = track_rays(cfg, BEAMS, RAYS, ctx=ctx_dev)
    np.testing.assert_array_equal(t_dev.launched, t_host.launched)
    np.testing.assert_array_equal(t_dev.steps, t_host.steps)
    np.testing.assert_array_equal(t_dev.recorded, t_host.recorded)
    m = t_host.recorded
    np.testing.assert_array_equal(t_dev.cell[m], t_host.cell[m])
    np.testing.assert_allclose(t_dev.pos[m], t_host.pos[m],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_dev.uray[m], t_host.uray[m], rtol=1e-12)
