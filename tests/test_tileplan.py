"""Static tile-liveness plan + segmented (mid-trace-compacted) trace:
the compacted trace must reproduce the plain trace exactly — compaction is
a pure work-skipping transformation (models/tileplan.py)."""

import jax
import pytest
import numpy as np

from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models import raytracer as rt
from cbet_raytracing_3d_tpu.models import tileplan as tp
from cbet_raytracing_3d_tpu.parallel.sharding import pad_rays


def _setup(profiles, **kw):
    kw.setdefault("dtype", "float64")
    cfg = Config(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
                 **kw)
    ctx = rt.prepare(cfg, profiles)
    rpt = ctx.layout.rays_per_tile
    state0 = pad_rays(rt.select_rays(ctx.state0, ctx.live_slots),
                      rpt)
    return cfg, ctx, rpt, state0


def test_plan_is_monotone_and_tiles_die(profiles):
    cfg, ctx, rpt, state0 = _setup(profiles)
    plan = tp.measure_plan(cfg, ctx, state0)
    live = plan.chunk_live
    # monotone: once dead, a tile stays dead
    assert not (np.diff(live.astype(int), axis=0) > 0).any()
    # the scene actually loses tiles mid-trace (what compaction exploits)
    assert live[-1].sum() < live[0].sum()


@pytest.mark.slow
def test_segmented_trace_matches_plain(profiles):
    cfg, ctx, rpt, state0 = _setup(profiles)
    plan = tp.measure_plan(cfg, ctx, state0)
    segments = tp.build_segments(plan, cfg.nt)
    assert len(segments) > 1, "scene produced no compaction opportunity"

    plain = jax.jit(rt.make_trace_fn(cfg))
    edep_p, state_p, of_p = plain(ctx.field4, state0)
    seg = jax.jit(rt.make_segmented_trace_fn(cfg, rpt, segments))
    edep_s, state_s, of_s = seg(ctx.field4, state0)

    assert int(of_p) == int(of_s) == 0
    np.testing.assert_allclose(np.asarray(edep_s), np.asarray(edep_p),
                               rtol=1e-12,
                               atol=1e-12 * float(np.asarray(edep_p).max()))
    # final-state slots map back to original slots with identical uray
    origins = rt.segment_slot_origins(segments, rpt)
    valid = origins >= 0
    up = np.asarray(state_p.uray)[origins[valid]]
    us = np.asarray(state_s.uray)[valid]
    np.testing.assert_allclose(us, up, rtol=0, atol=0)


def test_plan_cache_roundtrip(tmp_path, profiles):
    cfg, ctx, rpt, state0 = _setup(profiles)
    plan = tp.get_or_measure_plan(cfg, ctx, state0, str(tmp_path))
    # the cache key includes the traced slot layout (tile count): a plan
    # measured for a different device-count/padding layout must not load
    fp = (f"{tp.scene_fingerprint(ctx)}"
          f"_t{state0.n // ctx.layout.rays_per_tile}")
    loaded = tp.load_plan(tp.plan_path(str(tmp_path), fp), fp)
    assert loaded is not None
    np.testing.assert_array_equal(loaded.chunk_live, plan.chunk_live)
    # wrong fingerprint -> rejected
    assert tp.load_plan(tp.plan_path(str(tmp_path), fp), "deadbeef") is None


def test_plan_cache_invariant_to_deposit_knobs(tmp_path, profiles):
    """Deposit-stage / CBET-solver knobs cannot change the no-deposit
    liveness pre-trace, so they are normalized out of the plan cache key
    (tileplan._PLAN_FREE_FIELDS) — flipping them must HIT the cache (at
    config-4 scale a spurious re-measure costs ~9 minutes).  Physics knobs
    (stop_fraction) must still MISS."""
    cfg, ctx, rpt, state0 = _setup(profiles)
    tp.get_or_measure_plan(cfg, ctx, state0, str(tmp_path))

    import dataclasses as _dc
    knob = _dc.replace(ctx, cfg=cfg.replace(
        deposit_batch_steps=2, edep_dtype="float32", cbet_relax=0.5))
    fp_base = f"{tp.scene_fingerprint(ctx)}"
    assert tp.scene_fingerprint(knob) == fp_base

    physics = _dc.replace(ctx, cfg=cfg.replace(stop_fraction=0.0))
    assert tp.scene_fingerprint(physics) != fp_base


def test_build_segments_min_tiles_floor(profiles):
    """min_tiles stops splitting (each extra segment of a host-dispatched
    run costs a recompile): no segment after the first may hold fewer REAL
    tiles than the floor."""
    cfg, ctx, rpt, state0 = _setup(profiles)
    plan = tp.measure_plan(cfg, ctx, state0)
    base = tp.build_segments(plan, cfg.nt)
    assert len(base) > 1
    floor = max(int(s.valid.sum()) for s in base[1:]) + 1
    capped = tp.build_segments(plan, cfg.nt, min_tiles=floor)
    assert len(capped) < len(base)
    for s in capped[1:]:
        assert int(s.valid.sum()) >= floor
    # total steps preserved either way
    want = sum(len(c) and sum(c) for c in
               [s.chunk_lengths for s in base])
    got = sum(sum(s.chunk_lengths) for s in capped)
    assert got == want == cfg.nt


@pytest.mark.slow
def test_host_orchestrated_chunk_loop_matches_segmented_trace(profiles):
    """The config-4 composition (runner.run_composed): host-
    dispatched make_chunk_delta_fn chunks + segment_gather_rows transitions
    + pairwise f32 master must reproduce the one-jit segmented trace."""
    import dataclasses

    import jax.numpy as jnp

    cfg, ctx, rpt, state0 = _setup(profiles, dtype="float32")
    plan = tp.measure_plan(cfg, ctx, state0)
    segments = tp.build_segments(plan, cfg.nt)
    assert len(segments) > 1

    ref_fn = jax.jit(rt.make_segmented_trace_fn(cfg, rpt, segments))
    edep_ref, _, of_ref = ref_fn(ctx.field4, state0)
    assert int(of_ref) == 0

    chunk_fn = jax.jit(rt.make_chunk_delta_fn(cfg))
    state = state0
    oflow = jnp.int32(0)
    slots_acc = {}

    def acc_push(delta):
        lvl = 0
        while lvl in slots_acc:
            delta = slots_acc.pop(lvl) + delta
            lvl += 1
        slots_acc[lvl] = delta

    for si, seg in enumerate(segments):
        if si > 0:
            prev = segments[si - 1]
            pos = tp.segment_gather_rows(prev, seg,
                                         int(prev.tiles.max()) + 1)
            t_prev = len(prev.tiles)
            val = jnp.asarray(np.repeat(seg.valid, rpt))
            state = jax.tree_util.tree_map(
                lambda a: a.reshape(t_prev, rpt)[jnp.asarray(pos)]
                .reshape(-1), state)
            state = dataclasses.replace(state, alive=state.alive & val)
        for steps in seg.chunk_lengths:
            state, delta, oflow = chunk_fn(ctx.field4, state, oflow,
                                           jnp.int32(steps))
            acc_push(delta)
    assert int(oflow) == 0
    master = None
    for g in slots_acc.values():
        master = g if master is None else master + g
    edep = np.asarray(master, np.float64)
    ref = np.asarray(edep_ref, np.float64)
    rel = np.linalg.norm(edep - ref) / np.linalg.norm(ref)
    assert rel < 1e-6, rel

