"""End-to-end run orchestrator, mirroring the reference driver
(``rayTracing()``, main.cu:96-232): Init (profiles, fields, ray setup, device
upload) -> Tracing (device compute) -> Combining (cross-device reduction +
host download), with the reference's phase-timing report, plus run metrics,
checkpointing, and output writing the reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
from typing import Any

import jax
import numpy as np

from .config import Config
from .models import raytracer as rt
from .models.cbet import cbet_solve
from .parallel import sharding as sh
from .utils.accum import PairwiseAccumulator
from .utils.output import save_hdf5, save_npz, HAVE_H5PY
from .utils.timers import PhaseTimers


@dataclasses.dataclass
class RunResult:
    cfg: Config
    edep: np.ndarray             # ghost-padded (nx+2, ny+2, nz+2) float64
    stats: dict[str, Any]
    timings: dict[str, float]
    cbet: Any | None = None


def estimate_hbm_bytes(cfg: Config, with_cbet: bool = False) -> int:
    """Per-device memory demand — the checked-allocation analog of the
    reference's safeGPUAlloc free-memory preflight (multi_gpu.cpp:11-27).

    Models the resident arrays of the scatter-deposit path:

    * SoA ray state x2 (the context's state0 plus the padded working
      copy),
    * the (P, 4) float32 field table,
    * the (nx+2, ny+2, nz+2) grids: edep_dtype master + f32 chunk
      accumulator,
    * the per-step scatter operands: (8N,) corner indices and values,
    * CBET: the (B, P) gain/intensity node fields (x3: gain + two
      fixed-point iterates), the per-beam intensity grids (master + chunk
      accumulator), the optional 2-wide sliced gain rows, the memoized
      zero-gain intensity and the Anderson history."""
    from .models.raytracer import build_tile_layout
    # with_slots=False: the preflight only needs n_slots, and the slot_of
    # map costs O(nbeams*nrays) host time
    layout = build_tile_layout(cfg, with_slots=False)
    n_slots = layout.n_slots
    P = cfg.nx * cfg.ny * cfg.nz
    state_bytes = 11 * 4 + 3 * 4 + 1          # f32 SoA + int32 cells + alive
    state = 2 * n_slots * state_bytes
    field4 = P * 4 * 4
    gx, gy, gz = cfg.edep_shape
    master_bytes = 8 if cfg.edep_dtype == "float64" else 4
    grids = gx * gy * gz * (master_bytes + 4)
    scatter = 8 * n_slots * (4 + 4)
    cbet = 0
    if with_cbet:
        hx, hy, hz = cfg.cbet_grid_shape
        inten = cfg.nbeams * hx * hy * hz * 4
        cbet = (3 * cfg.nbeams * P * 4
                + 2 * cfg.nbeams * (hx + 2) * (hy + 2) * (hz + 2) * 4)
        rows2 = cfg.cbet_gain_rows2
        if rows2 is None:   # mirror the trace's auto rule (cbet.py)
            rows2 = cfg.nbeams * P * 4 * 2 <= 1.5e9
        if rows2 and cfg.cbet_gain_sliced:
            # the 2-wide value-duplicated sliced gain rows
            cbet += cfg.nbeams * P * 4 * 2
        if cfg.cbet_seed_zero_gain:
            cbet += inten   # the memoized zero-gain intensity
        if cfg.cbet_accel != "none":
            # Anderson(m=1) secant history: prev_x + prev_f + the live
            # residual (cbet.py _accel_next)
            cbet += 3 * inten
    return state + field4 + grids + scatter + cbet


def check_hbm(cfg: Config, with_cbet: bool = False) -> None:
    """Fail fast with a clear message when the run cannot fit — unlike the
    reference, which logs allocation errors and continues with bad pointers
    (SURVEY.md §5.3).  Devices that report no memory limit (the CPU) are
    not checked."""
    need = estimate_hbm_bytes(cfg, with_cbet)
    avail = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
    if avail and need > 0.95 * avail:
        raise RuntimeError(
            f"estimated device memory demand {need/2**30:.1f} GiB exceeds "
            f"device capacity {avail/2**30:.1f} GiB — reduce grid/ray "
            "counts or shard over more devices")


@dataclasses.dataclass(frozen=True)
class _PlanKey:
    """A tile plan as a cache key: equal by the digest of its chunk map."""
    digest: str
    plan: Any = dataclasses.field(compare=False)


def trace_fn(cfg: Config, mesh, rays_per_tile: int, plan,
             fused: bool = False):
    """The jitted trace ``run`` calls, cached across calls so a repeated
    run of the same config re-traces and re-compiles nothing: returns
    ``(fn, dev_segments)`` — the fused one-device GPU trace
    (ops/triton_trace.py) when ``fused``, else the plain sharded trace when
    ``plan`` is None, else the segmented one (single-device, or per-device
    balanced with its ``DeviceSegments``).  The fused and plain traces
    return ``(edep, state, overflow)``; the segmented ones add the
    full-length final ``(uray, alive)``."""
    import hashlib

    key = None if plan is None else _PlanKey(
        hashlib.sha256(plan.chunk_live.tobytes()).hexdigest(), plan)
    return _trace_fn(cfg, mesh, rays_per_tile, key, fused)


@functools.lru_cache(maxsize=4)
def _trace_fn(cfg: Config, mesh, rays_per_tile: int, plan_key, fused: bool):
    from .models import tileplan as tp

    n_dev = int(np.prod(mesh.devices.shape))
    if fused:
        from .ops import triton_trace
        return jax.jit(triton_trace.make_trace_fn(cfg)), None
    if plan_key is None:
        return sh.make_sharded_trace_fn(cfg, mesh), None
    if n_dev == 1:
        segments = tp.build_segments(plan_key.plan, cfg.nt)
        return jax.jit(rt.make_segmented_trace_fn(
            cfg, rays_per_tile, segments, track_final_state=True)), None
    dseg = tp.build_device_segments(plan_key.plan, cfg.nt, n_dev)
    return sh.make_sharded_segmented_trace_fn(
        cfg, mesh, rays_per_tile, dseg, track_final_state=True), dseg


def run(cfg: Config, *, with_cbet: bool = False, mesh=None,
        verbose: bool = True, profile_dir: str | None = None,
        cache_dir: str | None = None) -> RunResult:
    """Full simulation run with reference-parity phase accounting.

    On one GPU the trace is the fused Pallas-Triton kernel
    (ops/triton_trace.py — measured faster than the XLA trace on the H100,
    PERF.md); otherwise it is the XLA trace, segmented when ``cache_dir``
    provides a tile plan.  ``profile_dir`` captures a jax.profiler trace of
    the Tracing phase (SURVEY.md §5.1 — the reference only offers
    -lineinfo/nsight hooks).  ``cache_dir`` enables the prepare-products
    and tile-plan disk caches (see raytracer.prepare)."""
    import contextlib

    timers = PhaseTimers()
    check_hbm(cfg, with_cbet)
    profiler = (jax.profiler.trace(profile_dir) if profile_dir
                else contextlib.nullcontext())

    with timers.phase("Init"):
        import dataclasses as _dc
        import jax.numpy as _jnp
        if mesh is None:
            mesh = sh.make_mesh()
        n_dev = int(np.prod(mesh.devices.shape))
        if jax.default_backend() != "cpu":
            # on-device init (the reference's init() is accelerator code,
            # launch_ray_XZ.cu:65-115): the per-ray state is born on-chip
            # already live-tile compacted; host work is O(grid + nrays)
            ctx = rt.prepare_device(cfg)
            state0 = sh.pad_rays(ctx.state0,
                                 n_dev * ctx.layout.rays_per_tile)
        else:
            # CPU: host-state init — subset/pad in NumPy, one device_put
            # (pure transfers; device-side select/pad would compile per op)
            ctx = rt.prepare(cfg, host_state=True, cache_dir=cache_dir)
            state0 = sh.put_state(sh.pad_rays(
                rt.select_rays(ctx.state0, ctx.live_slots),
                n_dev * ctx.layout.rays_per_tile))
            ctx = _dc.replace(ctx, field4=_jnp.asarray(ctx.field4))
        # with a cache dir (except on one GPU): the statically compacted
        # (segmented) trace with final-state write-back — single-device or
        # per-device-balanced multi-device — so the termination/energy
        # accounting stays complete; the tile plan is measured once per
        # config+scene and disk-cached
        # the fused kernel stops each block of rays once they are all
        # dead, so it needs no compaction plan
        fused = n_dev == 1 and jax.default_backend() == "gpu"
        segmented = cache_dir is not None and not fused
        plan = None
        if segmented:
            from .models import tileplan as tp
            plan = tp.get_or_measure_plan(cfg, ctx, state0, cache_dir)
        fn, dseg = trace_fn(cfg, mesh, ctx.layout.rays_per_tile, plan,
                             fused)
        if dseg is not None:
            # reorder the SAME state the plan was measured on; mask the
            # per-device dup-padded balancing tiles so the final-state
            # accounting (trace_stats) never counts a ray twice
            state0 = sh.device_major_state(
                state0, ctx.layout.rays_per_tile, dseg)
            valid0 = np.repeat(np.asarray(dseg.valid[0]),
                               ctx.layout.rays_per_tile, axis=1).reshape(-1)
            state0 = _dc.replace(
                state0, alive=state0.alive & _jnp.asarray(valid0))

    with timers.phase("Tracing"), profiler:
        if segmented:
            edep_dev, seg_state, oflow, (uray_f, alive_f) = fn(
                ctx.field4, state0)
            state = _dc.replace(state0, uray=uray_f, alive=alive_f)
        else:
            edep_dev, state, oflow = fn(ctx.field4, state0)
        # fence: dispatch is async — the scalar fetch attributes the
        # device time to this phase like the reference's
        # cudaDeviceSynchronize (main.cu:175)
        oflow = int(jax.device_get(oflow))
    with timers.phase("Combining"):
        # the cross-device psum happens inside the jitted fn; what remains
        # is the grid download (the reference's D2H + host sum, main.cu:178-210)
        edep = np.asarray(jax.device_get(edep_dev), dtype=np.float64)

    rt.check_overflow(oflow)

    stats = rt.trace_stats(ctx, state, state0)
    stats["edep_total"] = float(edep.sum())
    stats["devices"] = n_dev

    cbet_result = None
    if with_cbet:
        with timers.phase("CBET"):
            cbet_result = cbet_solve(cfg, ctx, mesh=mesh)

    timings = timers.as_dict()
    if verbose:
        print(timers.report(), file=sys.stderr)
    return RunResult(cfg=cfg, edep=edep, stats=stats, timings=timings,
                     cbet=cbet_result)


def run_resumable(cfg: Config, *, checkpoint_path: str,
                  checkpoint_every: int = 4, resume: bool = False,
                  verbose: bool = True,
                  cache_dir: str | None = None) -> RunResult:
    """Single-device trace with chunk-granular checkpointing (SURVEY.md §5.4
    — an aux capability the reference lacks).  Interrupt-safe: re-invoke with
    ``resume=True`` to continue from the last saved chunk.

    CORRECTNESS-ONLY path: per-step deposits on the uncompacted host-prepared
    state (no segmentation, single device) — it trades the fast machinery
    for the simplest possible checkpoint invariant.  The resumable path for
    long runs is ``run_composed`` (segmented compaction + pairwise master +
    bit-identical resume)."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from .models.raytracer import make_chunk_fn
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    timers = PhaseTimers()
    with timers.phase("Init"):
        ctx = rt.prepare(cfg, host_state=True, cache_dir=cache_dir)
        state0 = rt.select_rays(ctx.state0, ctx.live_slots)
        state = sh.put_state(state0)
        ctx = _dc.replace(ctx, field4=jnp.asarray(ctx.field4))
        chunk = max(1, min(cfg.chunk_steps, cfg.nt))
        n_chunks = -(-cfg.nt // chunk)
        last_len = cfg.nt - (n_chunks - 1) * chunk
        fn_full = jax.jit(make_chunk_fn(cfg, chunk))
        fn_last = (fn_full if last_len == chunk else
                   jax.jit(make_chunk_fn(cfg, last_len)))
        master = jnp.zeros(cfg.edep_shape, rt.master_dtype(cfg))
        oflow = jnp.int32(0)
        start_chunk = 0
        if resume:
            start_chunk, master, state, of0 = load_checkpoint(
                checkpoint_path, cfg)
            oflow = jnp.int32(of0)
            if verbose:
                print(f"resumed at chunk {start_chunk}/{n_chunks}",
                      file=sys.stderr)

    with timers.phase("Tracing"):
        for ci in range(start_chunk, n_chunks):
            fn = fn_last if ci == n_chunks - 1 else fn_full
            state, master, oflow = fn(ctx.field4, state, master, oflow)
            if (ci + 1) % checkpoint_every == 0 or ci == n_chunks - 1:
                # one fetch fences AND reads
                of_now = int(jax.device_get(oflow))
                save_checkpoint(checkpoint_path, cfg, ci + 1, master, state,
                                of_now)
    with timers.phase("Combining"):
        edep = np.asarray(jax.device_get(master), np.float64)
        of = int(jax.device_get(oflow))
    rt.check_overflow(of)

    stats = rt.trace_stats(ctx, state, state0)
    stats["edep_total"] = float(edep.sum())
    if verbose:
        print(timers.report(), file=sys.stderr)
    return RunResult(cfg=cfg, edep=edep, stats=stats, timings=timers.as_dict())


def run_composed(cfg: Config, *, min_tiles: int = 0,
                 cache_dir: str | None = None,
                 checkpoint_path: str | None = None, resume: bool = False,
                 checkpoint_every_chunks: int | None = None,
                 verbose: bool = True,
                 stop_after_chunks: int | None = None) -> RunResult | None:
    """The composed large-scale trace (the BASELINE config-4 path) as a
    library capability: on-device init + host-orchestrated SEGMENTED tile
    compaction on a cached tile plan (chunk-by-chunk dispatch, so a long
    run is many short executions) + float64-equivalent master accumulation
    (binary-counter pairwise f32 reducer, log-depth), interrupt-safe.

    Checkpointing (``checkpoint_path``): after every segment's last chunk
    and every ``checkpoint_every_chunks`` chunks (if set), the current
    state, the full-slot accounting arrays, and the pairwise accumulator
    LEVELS are written atomically; ``resume=True`` continues from the last
    saved chunk with a bit-identical master (levels restored, not
    collapsed).  The checkpoint fingerprint covers config + segmentation.
    The reference has no analog (one-shot runs, SURVEY.md §5.4).

    ``stop_after_chunks`` (tests/drills): checkpoint and return ``None``
    after that many chunks have been executed in THIS invocation."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from .models import tileplan as tp
    from .models.raytracer import make_chunk_delta_fn
    from .utils.checkpoint import (config_fingerprint,
                                   load_composed_checkpoint,
                                   save_composed_checkpoint)

    timers = PhaseTimers()
    with timers.phase("Init"):
        if jax.default_backend() != "cpu":
            ctx = rt.prepare_device(cfg)
            s0 = ctx.state0
        else:
            ctx = rt.prepare(cfg, host_state=True, cache_dir=cache_dir)
            s0 = sh.put_state(rt.select_rays(ctx.state0, ctx.live_slots))
            ctx = _dc.replace(ctx, field4=jnp.asarray(ctx.field4))
        rpt = ctx.layout.rays_per_tile
        plan = tp.get_or_measure_plan(cfg, ctx, s0, cache_dir)
        segments = tp.build_segments(plan, cfg.nt, min_tiles=min_tiles)
        chunk_fn = jax.jit(make_chunk_delta_fn(cfg), donate_argnums=(1, 2))
        add = jax.jit(lambda a, b: a + b, donate_argnums=(0, 1))
        n0 = len(segments[0].tiles) * rpt
        # the run fingerprint covers everything that shapes the chunk
        # schedule and state layouts — resuming across any of these would
        # misalign slots silently (segment count alone is NOT enough; see
        # tileplan.segments_fingerprint)
        fingerprint = (f"{config_fingerprint(cfg)}-mt{min_tiles}"
                       f"-s{len(segments)}"
                       f"-{tp.segments_fingerprint(segments)}")
        # host copies for the final accounting: chunk_fn donates its state
        # argument, so s0's buffers die with the first chunk call
        uray_init_h = np.asarray(jax.device_get(s0.uray_init))
        alive0_h = np.asarray(jax.device_get(s0.alive))
        _copy = jax.jit(lambda a: a.copy())
        wb = jax.jit(lambda uf, af, u, a, ix: (
            uf.at[ix].set(u, mode="drop"), af.at[ix].set(a, mode="drop")),
            donate_argnums=(0, 1))

        def origin_slots(seg):
            return jnp.asarray(tp.origin_slots(seg.tiles, seg.valid, rpt,
                                               n0))

        start_ci = 0
        acc = PairwiseAccumulator(add)
        oflow = jnp.int32(0)
        state = s0
        uray_full, alive_full = _copy(s0.uray), _copy(s0.alive)
        if resume:
            (start_ci, state, uray_full, alive_full, levels,
             of0) = load_composed_checkpoint(checkpoint_path, fingerprint)
            acc = PairwiseAccumulator(add, levels=levels)
            oflow = jnp.int32(of0)
            if verbose:
                print(f"resumed at chunk {start_ci}", file=sys.stderr)

    def save(ci):
        save_composed_checkpoint(checkpoint_path, fingerprint, ci, state,
                                 uray_full, alive_full, acc.levels,
                                 int(jax.device_get(oflow)))

    executed = 0
    ci = 0
    with timers.phase("Tracing"):
        for si, seg in enumerate(segments):
            lens = seg.chunk_lengths
            if ci + len(lens) <= start_ci:
                ci += len(lens)        # segment fully done before resume
                continue
            if si > 0 and ci >= start_ci:
                # entering this segment fresh (the previous one ran in
                # THIS invocation, or the checkpoint sat exactly at the
                # boundary — checkpointed state is always pre-gather):
                # write back the finished tiles' final state and compact
                prev = segments[si - 1]
                uray_full, alive_full = wb(uray_full, alive_full,
                                           state.uray, state.alive,
                                           origin_slots(prev))
                pos = tp.segment_gather_rows(prev, seg,
                                             int(prev.tiles.max()) + 1)
                t_prev = len(prev.tiles)
                pos_j = jnp.asarray(pos)
                val_j = jnp.asarray(np.repeat(seg.valid, rpt))
                def _gath(st, p=pos_j, v=val_j, t=t_prev):
                    st = jax.tree_util.tree_map(
                        lambda a: a.reshape(t, rpt)[p].reshape(-1), st)
                    return _dc.replace(st, alive=st.alive & v)

                state = jax.jit(_gath)(state)
                if verbose:
                    print(f"  segment {si}: tiles {t_prev} -> "
                          f"{len(seg.tiles)}", file=sys.stderr)
            for steps in lens:
                if ci < start_ci:
                    ci += 1
                    continue
                state, delta, oflow = chunk_fn(ctx.field4, state, oflow,
                                               jnp.int32(steps))
                acc.push(delta)
                jax.device_get(oflow)      # fence (chunked dispatch)
                ci += 1
                executed += 1
                if verbose:
                    print(f"  chunk {ci}", file=sys.stderr)
                if (checkpoint_path and checkpoint_every_chunks
                        and executed % checkpoint_every_chunks == 0):
                    save(ci)
                if stop_after_chunks and executed >= stop_after_chunks:
                    if checkpoint_path:
                        save(ci)
                    return None
            if checkpoint_path and si < len(segments) - 1:
                save(ci)                   # segment boundary (pre-gather)

        uray_full, alive_full = wb(uray_full, alive_full, state.uray,
                                   state.alive,
                                   origin_slots(segments[-1]))
        master = acc.fold()
        of = int(jax.device_get(oflow))

    with timers.phase("Combining"):
        edep = np.asarray(jax.device_get(master), np.float64)
        uray_h = np.asarray(jax.device_get(uray_full), np.float64)
        alive_h = np.asarray(jax.device_get(alive_full))

    rt.check_overflow(of)
    launched = int(alive0_h.sum())
    alive_end = int(alive_h.sum())
    absorbed = float(np.sum((uray_init_h - uray_h)[alive0_h]))
    stats = {
        "rays_total": int(cfg.total_rays),
        "rays_launched": launched,
        "rays_alive_at_end": alive_end,
        "rays_terminated": launched - alive_end,
        "energy_launched": float(np.sum(
            np.asarray(uray_init_h, np.float64)[alive0_h])),
        "energy_absorbed": absorbed,
        "edep_total": float(edep.sum()),
        "segments": len(segments),
        "chunks": ci,
    }
    if verbose:
        print(timers.report(), file=sys.stderr)
    return RunResult(cfg=cfg, edep=edep, stats=stats,
                     timings=timers.as_dict())


def write_outputs(res: RunResult, outdir: str, formats: tuple[str, ...] = ("npz",),
                  basename: str = "edep") -> list[str]:
    """Persist a run.  When the run included the CBET stage, the CBET-coupled
    deposition, per-beam intensity fields, and convergence record are written
    alongside the uncoupled trace (npz extras / a ``*_cbet`` sibling for the
    schema-fixed hdf5+txt formats / a "cbet" json section)."""
    os.makedirs(outdir, exist_ok=True)
    cbet = res.cbet
    written = []
    for fmt in formats:
        path = os.path.join(outdir, f"{basename}.{fmt}")
        if fmt == "npz":
            extras = {}
            if cbet is not None:
                extras = {"cbet_edep": cbet.edep,
                          "cbet_intensity": cbet.intensity,
                          "cbet_iterations": np.int64(cbet.iterations),
                          "cbet_converged": np.bool_(cbet.converged),
                          "cbet_history": np.asarray(cbet.history)}
            save_npz(path, res.cfg, res.edep, res.stats, extras=extras)
        elif fmt == "hdf5":
            if not HAVE_H5PY:
                print("warning: h5py unavailable, skipping hdf5 output",
                      file=sys.stderr)
                continue
            save_hdf5(path, res.cfg, res.edep)
            if cbet is not None:
                cpath = os.path.join(outdir, f"{basename}_cbet.{fmt}")
                save_hdf5(cpath, res.cfg, cbet.edep)
                written.append(cpath)
        elif fmt == "txt":
            from .utils.native import write_print_dump
            write_print_dump(path, res.edep)
            if cbet is not None:
                cpath = os.path.join(outdir, f"{basename}_cbet.{fmt}")
                write_print_dump(cpath, cbet.edep)
                written.append(cpath)
        elif fmt == "json":
            payload = {"stats": res.stats, "timings": res.timings}
            if cbet is not None:
                payload["cbet"] = {
                    "iterations": cbet.iterations,
                    "converged": cbet.converged,
                    "history": [float(h) for h in cbet.history],
                    "edep_total": float(cbet.edep.sum()),
                    "stats": cbet.stats,
                }
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
        else:
            raise ValueError(f"unknown output format: {fmt}")
        written.append(path)
    return written
