"""Multi-device tests on the virtual 8-device CPU mesh (conftest.py):
shard_map ray sharding + psum grid reduction must reproduce the
single-device result (SURVEY.md §2 parallelism table, §5.8)."""

import jax
import numpy as np
import pytest

from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models import raytracer as rt
from cbet_raytracing_3d_tpu.parallel import sharding as sh


@pytest.fixture(scope="module")
def small_ctx(profiles):
    cfg = Config(dtype="float64")
    return rt.prepare(cfg, profiles)


def _subset(ctx, n=64):
    # spread rays over beams and pupil (slot indices)
    idx = np.linspace(0, ctx.layout.n_slots - 1, n).astype(np.int64)
    return rt.select_rays(ctx.state0, idx)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(small_ctx):
    ctx = small_ctx
    state0 = _subset(ctx, 64)

    single = jax.jit(rt.make_trace_fn(ctx.cfg))
    edep1, _, _ = single(ctx.field4, state0)

    mesh = sh.make_mesh()
    fn = sh.make_sharded_trace_fn(ctx.cfg, mesh)
    edep8, state8, _ = fn(ctx.field4, sh.pad_rays(state0, 8))

    np.testing.assert_allclose(np.asarray(edep8), np.asarray(edep1),
                               rtol=1e-12, atol=0)


def test_pad_rays_are_inert(small_ctx):
    ctx = small_ctx
    state0 = _subset(ctx, 61)  # not divisible by 8
    padded = sh.pad_rays(state0, 8)
    assert padded.uray.shape[0] == 64
    assert not bool(np.asarray(padded.alive[61:]).any())

    mesh = sh.make_mesh()
    fn = sh.make_sharded_trace_fn(ctx.cfg, mesh)
    edep, _, _ = fn(ctx.field4, padded)

    single = jax.jit(rt.make_trace_fn(ctx.cfg))
    edep1, _, _ = single(ctx.field4, state0)
    np.testing.assert_allclose(np.asarray(edep), np.asarray(edep1),
                               rtol=1e-12, atol=0)


@pytest.mark.slow
def test_uneven_beam_count_devices(small_ctx):
    """60 beams don't divide 8 devices — ray-axis sharding stays balanced
    (the reference hard-codes nGPUs=2 with beams%nGPUs==0, def.cuh:116)."""
    ctx = small_ctx
    state0 = _subset(ctx, 40)
    for ndev in (1, 2, 4, 8):
        mesh = sh.make_mesh(jax.devices()[:ndev])
        fn = sh.make_sharded_trace_fn(ctx.cfg, mesh)
        edep, _, _ = fn(ctx.field4, sh.pad_rays(state0, ndev))
        assert np.isfinite(np.asarray(edep)).all()


@pytest.mark.slow
def test_sharded_segmented_matches_single_device(profiles):
    """Per-device-balanced segmented trace (tileplan.build_device_segments +
    sharding.make_sharded_segmented_trace_fn): the multi-device form of
    static mid-trace compaction.  Must reproduce the plain sharded trace's
    deposition exactly in float64."""
    from cbet_raytracing_3d_tpu.models import tileplan as tp

    cfg = Config(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", chunk_steps=10)
    ctx = rt.prepare(cfg, profiles)
    rpt = ctx.layout.rays_per_tile
    state0 = sh.pad_rays(rt.select_rays(ctx.state0, ctx.live_slots),
                         rpt)

    single = jax.jit(rt.make_trace_fn(cfg))
    edep1, _, of1 = single(ctx.field4, state0)
    assert int(of1) == 0

    plan = tp.measure_plan(cfg, ctx, state0)
    for ndev in (1, 2, 4):
        dseg = tp.build_device_segments(plan, cfg.nt, ndev)
        assert len(dseg.chunk_lengths) > 1, "scene produced no compaction"
        mesh = sh.make_mesh(jax.devices()[:ndev])
        fn = sh.make_sharded_segmented_trace_fn(cfg, mesh, rpt, dseg)
        st0 = sh.device_major_state(state0, rpt, dseg)
        edep, state, oflow = fn(ctx.field4, st0)
        assert int(oflow) == 0
        np.testing.assert_allclose(np.asarray(edep), np.asarray(edep1),
                                   rtol=1e-12, atol=0)


def test_device_segments_balanced(profiles):
    """The round-robin-by-lifetime deal keeps per-device live-tile counts
    within one tile of each other in every segment."""
    from cbet_raytracing_3d_tpu.models import tileplan as tp

    cfg = Config(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", chunk_steps=10)
    ctx = rt.prepare(cfg, profiles)
    rpt = ctx.layout.rays_per_tile
    state0 = sh.pad_rays(rt.select_rays(ctx.state0, ctx.live_slots),
                         rpt)
    plan = tp.measure_plan(cfg, ctx, state0)
    dseg = tp.build_device_segments(plan, cfg.nt, 4)
    for valid in dseg.valid:
        counts = valid.sum(axis=1)
        assert counts.max() - counts.min() <= 1, counts

