"""End-to-end runner + CLI smoke tests on a small scene (CPU)."""

import json
import os
import subprocess
import pytest
import sys

import numpy as np

from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.runner import run, write_outputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(nbeams=2, rays_per_zone=1, nx=32, ny=32, nz=32,
         dtype="float64")


def test_run_end_to_end(tmp_path):
    cfg = Config(**SMALL)
    res = run(cfg, verbose=False)
    assert res.stats["rays_launched"] > 0
    assert res.stats["rays_terminated"] > 0
    np.testing.assert_allclose(res.stats["edep_total"],
                               res.stats["energy_absorbed"], rtol=1e-6)
    assert set(res.timings) >= {"Init", "Tracing", "Combining", "Total"}

    paths = write_outputs(res, str(tmp_path), ("npz", "json", "txt"))
    assert all(os.path.exists(p) for p in paths)
    meta = json.load(open(os.path.join(tmp_path, "edep.json")))
    assert meta["stats"]["rays_launched"] == res.stats["rays_launched"]


def test_cli_bool_or_none_flags():
    """'bool | None' config fields (tri-state: None = resolver decides)
    must parse strictly — without the dedicated branch, '--cbet-gain-rows2
    false' falls through to the plain-string parser and becomes the TRUTHY
    string 'false', silently inverting the user's intent."""
    import argparse

    from cbet_raytracing_3d_tpu import cli

    p = argparse.ArgumentParser()
    cli._add_config_flags(p)
    args = p.parse_args(["--cbet-gain-rows2", "false",
                         "--cbet-light-iterations", "none"])
    cfg = cli.config_from_args(args)
    assert cfg.cbet_gain_rows2 is False
    assert cfg.cbet_light_iterations is None
    args = p.parse_args(["--cbet-gain-rows2", "true"])
    assert cli.config_from_args(args).cbet_gain_rows2 is True
    with pytest.raises(SystemExit):
        p.parse_args(["--cbet-gain-rows2", "maybe"])


@pytest.mark.slow
def test_cli_run(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "cbet_raytracing_3d_tpu.cli", "run",
         "--nbeams", "1", "--rays-per-zone", "1", "--nx", "24", "--ny", "24",
         "--nz", "24", "--out-dir", str(tmp_path), "--formats", "npz,json",
         "--quiet"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.path.exists(os.path.join(tmp_path, "edep.npz"))


@pytest.mark.slow
def test_cli_run_composed(tmp_path):
    """`run --composed --checkpoint` routes through runner.run_composed and
    writes the same outputs as the plain path; `--composed` is trace-only
    (`--cbet` with it fails loud) and `--resume` needs `--checkpoint`."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    base = [sys.executable, "-m", "cbet_raytracing_3d_tpu.cli", "run",
            "--nbeams", "1", "--rays-per-zone", "1", "--nx", "24",
            "--ny", "24", "--nz", "24", "--formats", "npz,json", "--quiet"]
    out = subprocess.run(
        base + ["--composed", "--checkpoint", str(tmp_path / "c.npz"),
                "--out-dir", str(tmp_path), "--cache-dir",
                str(tmp_path / "cache")],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.path.exists(os.path.join(tmp_path, "edep.npz"))
    # (a single-segment tiny run legitimately writes no boundary
    # checkpoint; run_composed's resume semantics are covered by
    # test_run_composed_resume_bit_identical)

    bad = subprocess.run(base + ["--composed", "--cbet"],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert bad.returncode == 2 and "trace-only" in bad.stderr
    bad = subprocess.run(base + ["--resume"],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert bad.returncode == 2 and "--checkpoint" in bad.stderr


@pytest.mark.slow
def test_checkpoint_resume(tmp_path):
    """run_resumable from scratch == fresh run; resuming mid-trace from a
    checkpoint reproduces the same final deposition."""
    from cbet_raytracing_3d_tpu.runner import run_resumable
    from cbet_raytracing_3d_tpu.utils.checkpoint import load_checkpoint

    cfg = Config(**SMALL, chunk_steps=16)
    ck = str(tmp_path / "trace.ckpt.npz")
    full = run_resumable(cfg, checkpoint_path=ck, checkpoint_every=2,
                         verbose=False)
    ref = run(cfg, verbose=False)
    np.testing.assert_allclose(full.edep, ref.edep, rtol=1e-12, atol=0)

    # simulate an interruption: rewind to an intermediate checkpoint by
    # running with checkpointing, then resume and compare
    cfg2 = cfg
    ck2 = str(tmp_path / "trace2.ckpt.npz")
    # run only the first chunks by raising an interrupt via small max? —
    # instead: checkpoint_every=1 and manually load an early checkpoint
    run_resumable(cfg2, checkpoint_path=ck2, checkpoint_every=1, verbose=False)
    ci, master, state, of = load_checkpoint(ck2, cfg2)
    assert ci == -(-cfg2.nt // cfg2.chunk_steps)   # final checkpoint exists

    resumed = run_resumable(cfg2, checkpoint_path=ck2, resume=True,
                            verbose=False)
    np.testing.assert_allclose(resumed.edep, full.edep, rtol=1e-12, atol=0)


def test_checkpoint_rejects_wrong_config(tmp_path):
    from cbet_raytracing_3d_tpu.runner import run_resumable
    from cbet_raytracing_3d_tpu.utils.checkpoint import load_checkpoint

    cfg = Config(**SMALL, chunk_steps=16)
    ck = str(tmp_path / "t.npz")
    run_resumable(cfg, checkpoint_path=ck, verbose=False)
    other = cfg.replace(intensity=2e14)
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(ck, other)


@pytest.mark.slow
def test_run_composed_matches_run(tmp_path):
    """run_composed (the config-4 composed loop as a library capability:
    segmented compaction + pairwise f32 master, host-dispatched chunks)
    reproduces the plain run's physics on a small scene."""
    from cbet_raytracing_3d_tpu.runner import run_composed

    cfg = Config(**SMALL, chunk_steps=8)
    res_c = run_composed(cfg, cache_dir=str(tmp_path), verbose=False)
    res_p = run(cfg, verbose=False)
    rel = (np.linalg.norm(res_c.edep - res_p.edep)
           / np.linalg.norm(res_p.edep))
    assert rel < 1e-6, rel
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert res_c.stats[key] == res_p.stats[key], key
    np.testing.assert_allclose(res_c.stats["edep_total"],
                               res_c.stats["energy_absorbed"], rtol=1e-6)


def test_run_composed_resume_bit_identical(tmp_path):
    """Interrupt the composed loop mid-run (checkpoint saved), resume, and
    get a BIT-IDENTICAL result — the pairwise accumulator levels are
    restored level-by-level, not collapsed, so the f32 addition tree is
    the same as an uninterrupted run's."""
    from cbet_raytracing_3d_tpu.runner import run_composed

    cfg = Config(**SMALL, chunk_steps=8)
    ckpt = str(tmp_path / "composed.npz")
    full = run_composed(cfg, cache_dir=str(tmp_path), verbose=False)
    # interrupted: stop after 2 chunks (checkpointing every chunk so the
    # stop lands mid-segment), then resume to completion
    out = run_composed(cfg, cache_dir=str(tmp_path), checkpoint_path=ckpt,
                       checkpoint_every_chunks=1, stop_after_chunks=2,
                       verbose=False)
    assert out is None and os.path.exists(ckpt)
    res = run_composed(cfg, cache_dir=str(tmp_path), checkpoint_path=ckpt,
                       resume=True, verbose=False)
    np.testing.assert_array_equal(res.edep, full.edep)
    assert res.stats == full.stats


@pytest.mark.slow
def test_run_composed_resume_bit_identical_three_levels(tmp_path):
    """Resume at a point where 3+ pairwise-accumulator LEVELS survive to the
    final fold: chunk_steps=19 -> 7 chunks (binary 111 = three
    levels at the end); stopping after chunk 6 restores levels {1,2} from
    the checkpoint and pushes one more.  The fold must run in a canonical
    order on both paths or the addition tree (and the master grid's low
    bits) differs between an uninterrupted and a resumed run."""
    from cbet_raytracing_3d_tpu.runner import run_composed

    cfg = Config(**SMALL, chunk_steps=19)
    ckpt = str(tmp_path / "composed3.npz")
    full = run_composed(cfg, cache_dir=str(tmp_path), verbose=False)
    out = run_composed(cfg, cache_dir=str(tmp_path), checkpoint_path=ckpt,
                       checkpoint_every_chunks=1, stop_after_chunks=6,
                       verbose=False)
    assert out is None and os.path.exists(ckpt)
    res = run_composed(cfg, cache_dir=str(tmp_path), checkpoint_path=ckpt,
                       resume=True, verbose=False)
    np.testing.assert_array_equal(res.edep, full.edep)
    assert res.stats == full.stats


def test_run_composed_checkpoint_rejects_different_run(tmp_path):
    """A composed checkpoint must not resume a structurally different run
    (config fingerprint mismatch fails loud)."""
    import pytest

    from cbet_raytracing_3d_tpu.runner import run_composed

    cfg = Config(**SMALL, chunk_steps=8)
    ckpt = str(tmp_path / "composed.npz")
    run_composed(cfg, cache_dir=str(tmp_path), checkpoint_path=ckpt,
                 checkpoint_every_chunks=1, stop_after_chunks=1,
                 verbose=False)
    other = Config(**{**SMALL, "rays_per_zone": 2}, chunk_steps=8)
    with pytest.raises(ValueError, match="fingerprint"):
        run_composed(other, cache_dir=str(tmp_path), checkpoint_path=ckpt,
                     resume=True, verbose=False)


def test_hbm_preflight():
    """Oversized configs fail fast with a clear message (unlike the
    reference, which logs cudaMalloc errors and continues — SURVEY.md §5.3)."""
    from cbet_raytracing_3d_tpu.runner import check_hbm, estimate_hbm_bytes
    cfg = Config(**SMALL)
    check_hbm(cfg)                      # small scene must pass
    assert estimate_hbm_bytes(cfg) > 0
    big = Config(nx=400, ny=400, nz=400, nbeams=60)
    try:
        avail = __import__("jax").devices()[0].memory_stats() or {}
    except Exception:
        avail = {}
    if avail.get("bytes_limit"):
        import pytest as _pytest
        with _pytest.raises(RuntimeError, match="HBM"):
            check_hbm(big, with_cbet=True)


@pytest.mark.slow
def test_run_with_cbet(tmp_path):
    """runner.run(with_cbet=True): the full pipeline including the CBET phase
    and its timings."""
    cfg = Config(nbeams=2, rays_per_zone=1, nx=32, ny=32, nz=32,
                 dtype="float64", cbet_max_iters=4, cbet_tol=1e-2)
    res = run(cfg, with_cbet=True, verbose=False)
    assert res.cbet is not None
    assert res.cbet.intensity.shape == (2, 32, 32, 32)
    assert "CBET" in res.timings
    assert np.isfinite(res.cbet.edep).all()


@pytest.mark.slow
def test_cli_dump(tmp_path):
    """`cli dump` emits the reference -D PRINT format (nested brackets over
    the full ghost-padded grid) on stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "cbet_raytracing_3d_tpu.cli", "dump",
         "--nbeams", "1", "--rays-per-zone", "1", "--nx", "16", "--ny", "16",
         "--nz", "16"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout
    assert text.startswith("[[[")
    # 18^3 values in the ghost-padded grid
    n_vals = text.count(",") + text.count("]\n[") + 1
    rows = text.count("]\n")
    assert rows == 18 * 18 + 18 + 1   # one ']\n' per z-row, per y-plane, per grid


def test_hbm_estimate_models_real_terms():
    """The preflight models the GPU layout's resident terms: the (P, 4)
    field table and the (nx+2, ny+2, nz+2) grids with no padding,
    both state copies and the scatter operands, and the CBET fields.
    Anchors: the OMEGA trace needs well under a GiB, BASELINE config 4
    (64M rays on a 200^3 grid) with CBET fits one 80 GB card."""
    from cbet_raytracing_3d_tpu.runner import estimate_hbm_bytes

    cfg = Config()
    est = estimate_hbm_bytes(cfg)
    assert 0.1 * 2**30 < est < 1 * 2**30, est / 2**30
    P = cfg.nx * cfg.ny * cfg.nz

    est_cbet = estimate_hbm_bytes(cfg, with_cbet=True)
    # CBET adds the (B, P) fields x3 + per-beam intensity grids
    assert est_cbet > est + 3 * cfg.nbeams * P * 4
    # the lookup mode's auto rows2 adds the 2-wide sliced table (480 MB)
    est_no2 = estimate_hbm_bytes(cfg.replace(cbet_gain_rows2=False),
                                 with_cbet=True)
    assert est_cbet - est_no2 == cfg.nbeams * P * 4 * 2

    cfg4 = cfg.replace(nx=200, ny=200, nz=200, rays_per_zone=15,
                       tile_zones=2)
    est4 = estimate_hbm_bytes(cfg4)
    assert 4 * 2**30 < est4 < 30 * 2**30, est4 / 2**30
    est4c = estimate_hbm_bytes(cfg4, with_cbet=True)
    assert est4c < 0.95 * 80e9
    # config-4's 3.9 GB full-res table turns auto-rows2 OFF
    assert est4c == estimate_hbm_bytes(cfg4.replace(cbet_gain_rows2=False),
                                       with_cbet=True)


def test_prepare_cache_roundtrip(tmp_path):
    """The prepare-products disk cache (Init <5s contract) must reproduce a
    fresh prepare exactly — same state, fields table, liveness, beam ids."""
    import numpy as np

    from cbet_raytracing_3d_tpu.models import raytracer as rt

    cfg = Config(nbeams=3, rays_per_zone=1, nx=20, ny=20, nz=20)
    cache = str(tmp_path / "prep")
    built = rt.prepare(cfg, host_state=True, cache_dir=cache)   # build + save
    loaded = rt.prepare(cfg, host_state=True, cache_dir=cache)  # cache hit
    fresh = rt.prepare(cfg, host_state=True)

    for ctx in (built, loaded):
        for name in ("frac", "vel", "kick", "cell"):
            for i in range(3):
                np.testing.assert_array_equal(
                    getattr(ctx.state0, name)[i],
                    getattr(fresh.state0, name)[i])
        for name in ("uray", "uray_init", "alive"):
            np.testing.assert_array_equal(getattr(ctx.state0, name),
                                          getattr(fresh.state0, name))
        np.testing.assert_array_equal(np.asarray(ctx.field4),
                                      np.asarray(fresh.field4))
        np.testing.assert_array_equal(ctx.beam_id, fresh.beam_id)
        np.testing.assert_array_equal(ctx.live_slots, fresh.live_slots)
        np.testing.assert_array_equal(ctx.fields.eden, fresh.fields.eden)

    # a config change must miss (different fingerprint), not collide
    cfg2 = cfg.replace(nx=24)
    other = rt.prepare(cfg2, host_state=True, cache_dir=cache)
    assert other.field4.shape != loaded.field4.shape


@pytest.mark.slow
def test_run_segmented_matches_plain(tmp_path):
    """run() with a cache_dir takes the compacted (segmented) trace path
    with final-state write-back — deposition AND the full termination/
    energy accounting must match the plain path exactly (float64)."""
    cfg = Config(**SMALL)
    plain = run(cfg, verbose=False)
    seg = run(cfg, verbose=False, cache_dir=str(tmp_path / "cache"))
    np.testing.assert_allclose(seg.edep, plain.edep, rtol=1e-12, atol=0)
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert seg.stats[key] == plain.stats[key], key
    np.testing.assert_allclose(seg.stats["energy_absorbed"],
                               plain.stats["energy_absorbed"], rtol=1e-12)
    # second call hits both disk caches (prepare + tile plan)
    seg2 = run(cfg, verbose=False, cache_dir=str(tmp_path / "cache"))
    np.testing.assert_allclose(seg2.edep, plain.edep, rtol=1e-12, atol=0)


@pytest.mark.slow
def test_run_segmented_accounting_with_coasting_rays(tmp_path):
    """Scene with rays that coast through zero-absorption cells (the
    non-monotone-liveness case): the compacted path must still report the
    same termination/energy accounting as the plain trace — the tile plan
    uses alive-based liveness so still-stepping rays are never dropped."""
    cfg = Config(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", chunk_steps=10)
    plain = run(cfg, verbose=False)
    seg = run(cfg, verbose=False, cache_dir=str(tmp_path / "cache"))
    np.testing.assert_allclose(seg.edep, plain.edep, rtol=1e-12, atol=0)
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert seg.stats[key] == plain.stats[key], (
            key, seg.stats[key], plain.stats[key])
    np.testing.assert_allclose(seg.stats["energy_absorbed"],
                               plain.stats["energy_absorbed"], rtol=1e-12)


@pytest.mark.slow
def test_run_multidevice_segmented_matches_plain(tmp_path):
    """run() on a multi-device mesh with a cache_dir takes the per-device-
    balanced segmented trace (the SAME fast path bench.py measures) with
    final-state write-back: deposition and the full termination/energy
    accounting must match the plain sharded path exactly (float64)."""
    import jax

    from cbet_raytracing_3d_tpu.parallel import sharding as sh

    cfg = Config(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", chunk_steps=10)
    mesh = sh.make_mesh(jax.devices()[:4])
    plain = run(cfg, verbose=False, mesh=mesh)
    seg = run(cfg, verbose=False, mesh=mesh,
              cache_dir=str(tmp_path / "cache"))
    np.testing.assert_allclose(seg.edep, plain.edep, rtol=1e-12, atol=0)
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert seg.stats[key] == plain.stats[key], (
            key, seg.stats[key], plain.stats[key])
    np.testing.assert_allclose(seg.stats["energy_absorbed"],
                               plain.stats["energy_absorbed"], rtol=1e-12)


def test_write_outputs_with_cbet(tmp_path):
    """A CBET run's outputs: npz extras, the json "cbet" section, and the
    *_cbet.txt sibling dump (runner.write_outputs cbet branches)."""
    cfg = Config(nbeams=2, rays_per_zone=1, nx=32, ny=32, nz=32,
                 dtype="float64", cbet_max_iters=3, cbet_tol=1e-2)
    res = run(cfg, with_cbet=True, verbose=False)
    paths = write_outputs(res, str(tmp_path), ("npz", "json", "txt"))
    assert all(os.path.exists(p) for p in paths)

    npz = np.load(os.path.join(tmp_path, "edep.npz"))
    assert npz["cbet_edep"].shape == res.edep.shape
    assert npz["cbet_intensity"].shape == (2, 32, 32, 32)
    assert int(npz["cbet_iterations"]) == res.cbet.iterations
    assert npz["cbet_history"].shape == (len(res.cbet.history),)

    meta = json.load(open(os.path.join(tmp_path, "edep.json")))
    assert meta["cbet"]["iterations"] == res.cbet.iterations
    np.testing.assert_allclose(meta["cbet"]["edep_total"],
                               float(res.cbet.edep.sum()), rtol=1e-12)

    side = os.path.join(tmp_path, "edep_cbet.txt")
    assert os.path.exists(side)
    # the sibling dump is the CBET-coupled grid, not the uncoupled one
    from cbet_raytracing_3d_tpu.utils.output import dump_print_format
    assert open(side).read() == dump_print_format(np.asarray(res.cbet.edep))


def test_cli_rejects_bad_flag_values():
    """Typo'd boolean or Literal flag values must ERROR, not silently run a
    different model ('--absorption on' used to parse to False)."""
    from cbet_raytracing_3d_tpu import cli

    p = __import__("argparse").ArgumentParser()
    cli._add_config_flags(p)
    ns = p.parse_args(["--absorption", "on", "--parity", "reference"])
    assert ns.absorption is True and ns.parity == "reference"
    ns = p.parse_args(["--cbet-gain-sliced", "OFF"])
    assert ns.cbet_gain_sliced is False
    import pytest as _pytest
    for bad in (["--absorption", "o"], ["--parity", "Reference"],
                ["--cbet-gain-mode", "bogus"], ["--dtype", "f32"]):
        with _pytest.raises(SystemExit):
            p.parse_args(bad)



def test_trace_fn_fused_matches_plain(monkeypatch):
    """run()'s one-GPU trace (the fused Triton kernel, here in interpret
    mode with one ray per program) matches the plain XLA trace it
    replaces, keeps the full final state, and is cached per config."""
    import functools

    import jax

    from cbet_raytracing_3d_tpu import runner
    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.ops import triton_trace
    from cbet_raytracing_3d_tpu.parallel import sharding as sh

    monkeypatch.setattr(triton_trace, "make_trace_fn", functools.partial(
        triton_trace.make_trace_fn, block=1, interpret=True))
    cfg = Config(**SMALL)
    ctx = rt.prepare(cfg)
    state0 = rt.select_rays(ctx.state0, ctx.live_slots)
    mesh = sh.make_mesh(jax.devices()[:1])
    rpt = ctx.layout.rays_per_tile
    fused, dseg = runner.trace_fn(cfg, mesh, rpt, None, fused=True)
    assert dseg is None
    assert runner.trace_fn(cfg, mesh, rpt, None, fused=True)[0] is fused
    plain, _ = runner.trace_fn(cfg, mesh, rpt, None)
    assert plain is not fused
    e_f, st_f, of = fused(ctx.field4, state0)
    e_p, st_p, _ = plain(ctx.field4, state0)
    assert int(of) == 0 and st_f.n == state0.n
    np.testing.assert_allclose(np.asarray(e_f), np.asarray(e_p), rtol=1e-12,
                               atol=1e-12 * float(np.asarray(e_p).max()))
    np.testing.assert_array_equal(np.asarray(st_f.alive),
                                  np.asarray(st_p.alive))
