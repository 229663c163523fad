"""Smoke test of the whole system on one NVIDIA GPU — the quickest proof
that the program still starts, runs at full OMEGA width and gets the right
answer on the card.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

One process drives the card(s).  Phases on one card (any failure exits
non-zero):

* trace    — ``runner.run(Config())`` twice (the second timed): no lost
             deposits, every ray terminated, edep total == absorbed energy,
             rel-L2 < 1e-4 against ``artifacts/omega_golden.npz`` (the
             scene traced in float64);
* oracle   — the config-1 scene (tests/test_golden.py) against the float64
             oracle golden: < 1e-9 in float64, < 1e-4 in float32;
* gain     — the XLA gain reduction at OMEGA width against float64 NumPy of
             the formula, built from the scene tables alone, on 4096
             sampled nodes;
* cbet     — ``cli run --cbet`` in-process: converges in the golden's 5
             iterations, rel-L2 < 1e-4 against ``artifacts/cbet_golden.npz``
             (the float64 solve);
* composed — ``runner.run_composed(Config())`` (XLA, donated chunk
             buffers) against the trace phase's grid, rel-L2 < 1e-5;
* triton   — the trace phase ran the fused Pallas-Triton kernel
             (ops/triton_trace.py); the plain XLA trace of the same state
             must match its grid at rel-L2 < 1e-5, and both are timed.

``--four-cards``: the sharded segmented XLA trace on a 4-device mesh against
the same trace on a 1-device mesh (rel-L2 < 1e-5), and the sharded CBET
solve against the 1-device solve (rel-L2 < 1e-4).

Every time printed carries the card's name and power limit.  The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".cbet_cache")          # listed in .gitignore


class PhaseError(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def rel_l2(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def peak_gib(device) -> float:
    return (device.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30


def phase_trace(cfg, card: str, log) -> "np.ndarray":
    import numpy as np

    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.runner import run

    run(cfg, verbose=False, cache_dir=WORK)                 # compile + plan
    res = run(cfg, verbose=False, cache_dir=WORK)
    st = res.stats
    absorbed = st["energy_absorbed"]
    cons = abs(st["edep_total"] - absorbed) / absorbed
    gold = np.load(os.path.join(REPO, "artifacts", "omega_golden.npz"))
    rel = rel_l2(res.edep, gold["edep"])
    t = res.timings["Tracing"]
    log(f"trace: master dtype {rt.master_dtype(cfg).name}; "
        f"{st['rays_launched']} rays launched, {st['rays_alive_at_end']} "
        f"alive at end; |edep-absorbed|/absorbed {cons:.3e}; rel-L2 vs "
        f"the float64 omega golden {rel:.3e}")
    log(f"trace: steady Tracing {t:.4f} s, Init {res.timings['Init']:.4f} s "
        f"= {cfg.total_rays * cfg.nt / t:.4e} nominal ray-steps/s "
        f"[{card}]")
    _check(st["rays_launched"] > 0, "no rays launched")
    _check(st["rays_alive_at_end"] == 0,
           f"{st['rays_alive_at_end']} rays still alive after nt steps")
    _check(cons < 1e-6, f"energy bookkeeping off by {cons:.3e}")
    _check(rel < 1e-4, f"rel-L2 vs omega golden {rel:.3e} >= 1e-4")
    return res.edep


def phase_oracle(card: str, log) -> None:
    import jax
    import numpy as np

    from cbet_raytracing_3d_tpu.config import Config
    from cbet_raytracing_3d_tpu.models import raytracer as rt

    gold = np.load(os.path.join(REPO, "tests", "golden",
                                "config1_oracle.npz"))
    for dtype, bar in (("float64", 1e-9), ("float32", 1e-4)):
        cfg = Config(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                     dtype=dtype)
        # x64 only for the float64 pass, scoped so no other phase sees it
        with jax.enable_x64(dtype == "float64"):
            ctx = rt.prepare(cfg)
            state0 = rt.select_rays(ctx.state0,
                                    ctx.layout.slot_of[0, gold["rays"]])
            edep, _, oflow = jax.jit(rt.make_trace_fn(cfg))(ctx.field4,
                                                            state0)
            edep = np.asarray(edep, np.float64)
            _check(int(oflow) == 0, "lost deposits")
        rel = rel_l2(edep, gold["edep"])
        log(f"oracle: config-1 {dtype} rel-L2 vs float64 oracle {rel:.3e} "
            f"(bar {bar:g})")
        _check(rel < bar, f"config-1 {dtype} rel-L2 {rel:.3e} >= {bar:g}")


def gain_reference(cfg, inten, cols):
    """float64 NumPy of the CBET gain formula (models/cbet.py docstring) at
    the flat node indices ``cols``, built from the scene tables alone —
    node positions, the radial ne profile, the beam ports and the physical
    constants — without models/cbet.py.  Returns ``(gain, scale)`` of shape
    (B, len(cols)); ``scale`` is the magnitude of the summed partner terms,
    the scale a float32 sum of B signed terms is accurate to."""
    import numpy as np

    from cbet_raytracing_3d_tpu import constants as k
    from cbet_raytracing_3d_tpu.beams import load_beam_norms
    from cbet_raytracing_3d_tpu.profiles import load_profiles

    idx = np.unravel_index(cols, (cfg.nx, cfg.ny, cfg.nz))
    pos = np.stack([i * d + lo for i, d, lo in zip(
        idx, (cfg.dx, cfg.dy, cfg.dz), (cfg.xmin, cfg.ymin, cfg.zmin))])
    r = np.sqrt((pos ** 2).sum(axis=0))
    rhat = pos / np.where(r > 0, r, 1.0)                    # (3, n)
    prof = load_profiles(nr=cfg.nr)
    order = np.argsort(prof.r)
    f = np.clip(np.interp(r, prof.r[order], prof.ne[order]) / k.NCRIT,
                0.0, 0.95)
    # constant1 (def.cuh:111) times the W/cm^2 -> statvolt^2/cm^2 factor
    pre = k.CONSTANT1 * 8e7 * np.pi / k.C_CMS * f / np.sqrt(1.0 - f)
    bn = load_beam_norms(nbeams=cfg.nbeams)
    khat = -bn / np.linalg.norm(bn, axis=1, keepdims=True)
    dk = khat[None, :, :] - khat[:, None, :]     # [b, p] = k_p - k_b
    norm = np.linalg.norm(dk, axis=-1, keepdims=True)
    unit = dk / np.where(norm > 0, norm, 1.0)    # zero on the diagonal
    eta = -cfg.machnum * np.einsum("bpk,kn->bpn", unit, rhat)
    resp = k.IAW ** 2 * eta / ((eta ** 2 - 1.0) ** 2 + k.IAW ** 2 * eta ** 2)
    terms = resp * inten[:, cols].astype(np.float64)[None]
    return pre * terms.sum(axis=1), np.abs(pre) * np.abs(terms).sum(axis=1)


def phase_gain(cfg, card: str, log) -> None:
    import jax.numpy as jnp
    import numpy as np

    from cbet_raytracing_3d_tpu.models import cbet
    from cbet_raytracing_3d_tpu.models import raytracer as rt

    ctx = rt.prepare_device(cfg)
    gain_fn = cbet.make_gain_fn(cfg, ctx)
    B, P = cfg.nbeams, cfg.nx * cfg.ny * cfg.nz
    rng = np.random.default_rng(0)
    inten = (rng.random((B, P), np.float32) * 1e14).astype(np.float32)
    inten_d = jnp.asarray(inten)
    g = gain_fn(inten_d).block_until_ready()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        g = gain_fn(inten_d)
    g.block_until_ready()
    dt = (time.perf_counter() - t0) / n
    cols = rng.choice(P, 4096, replace=False)
    ref, scale = gain_reference(cfg, inten, cols)
    g = np.asarray(g)[:, cols].astype(np.float64)
    err = float((np.abs(g - ref) / np.maximum(scale, 1e-300)).max())
    log(f"gain: {B}x{P} XLA reduction {dt * 1e3:.3f} ms/call; max rel err "
        f"vs float64 NumPy of the formula {err:.3e} [{card}]")
    _check(err < 1e-5, f"gain max rel err {err:.3e} >= 1e-5")


def phase_cbet(card: str, log, scene_args=()) -> None:
    import numpy as np

    from cbet_raytracing_3d_tpu import cli

    out = os.path.join(WORK, "smoke_cbet")
    t0 = time.perf_counter()
    rc = cli.main(["run", "--cbet", "--out-dir", out, "--formats", "npz,json",
                   "--quiet", "--cache-dir", WORK, *scene_args])
    wall = time.perf_counter() - t0
    _check(rc == 0, f"cli run --cbet returned {rc}")
    with open(os.path.join(out, "edep.json")) as f:
        rec = json.load(f)
    c = rec["cbet"]
    edep = np.load(os.path.join(out, "edep.npz"))["cbet_edep"]
    gold_npz = np.load(os.path.join(REPO, "artifacts", "cbet_golden.npz"))
    with open(os.path.join(REPO, "artifacts", "cbet_golden.json")) as f:
        gold = json.load(f)
    gold_iters = gold["iterations"]
    rel = rel_l2(edep, gold_npz["edep"])
    excess = c["edep_total"] - c["stats"]["energy_absorbed"]
    log(f"cbet: {c['iterations']} iterations (golden {gold_iters}), "
        f"converged {c['converged']}, history "
        f"{[round(h, 5) for h in c['history']]}; rel-L2 vs the "
        f"{gold['dtype']} cbet golden {rel:.3e}; energy excess "
        f"edep_total - energy_absorbed {excess:.6e}")
    log(f"cbet: cli run --cbet wall {wall:.2f} s (CBET phase "
        f"{rec['timings']['CBET']:.3f} s, iterations "
        f"{c['stats']['iter_seconds']} s) [{card}]")
    _check(c["converged"] and c["iterations"] == gold_iters,
           f"CBET took {c['iterations']} iterations (golden {gold_iters})")
    _check(rel < 1e-4, f"rel-L2 vs cbet golden {rel:.3e} >= 1e-4")


def phase_composed(cfg, edep_ref, card: str, log) -> None:
    from cbet_raytracing_3d_tpu.runner import run_composed

    res = run_composed(cfg, cache_dir=WORK, verbose=False)
    rel = rel_l2(res.edep, edep_ref)
    log(f"composed: {res.stats['segments']} segments, "
        f"{res.stats['chunks']} chunks; rel-L2 vs trace {rel:.3e}; "
        f"Tracing {res.timings['Tracing']:.3f} s [{card}]")
    _check(rel < 1e-5, f"composed rel-L2 vs trace {rel:.3e} >= 1e-5")


def phase_triton(cfg, edep_ref, card: str, log) -> None:
    import jax

    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.ops import triton_trace

    ctx = rt.prepare_device(cfg)
    fns = {"xla": jax.jit(rt.make_trace_fn(cfg)),
           "triton": jax.jit(triton_trace.make_trace_fn(cfg))}
    grids, best = {}, {}
    for name, fn in fns.items():
        grids[name] = fn(ctx.field4, ctx.state0)[0].block_until_ready()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(ctx.field4, ctx.state0)[0].block_until_ready()
            times.append(time.perf_counter() - t0)
        best[name] = min(times)
    rel = rel_l2(grids["triton"], grids["xla"])
    rel_run = rel_l2(edep_ref, grids["xla"])
    log(f"triton: fused trace {best['triton'] * 1e3:.3f} ms vs XLA trace "
        f"{best['xla'] * 1e3:.3f} ms (best of 5, same state); rel-L2 "
        f"triton vs XLA {rel:.3e}, trace phase vs XLA {rel_run:.3e} "
        f"[{card}]")
    _check(rel < 1e-5, f"triton vs XLA rel-L2 {rel:.3e} >= 1e-5")
    _check(rel_run < 1e-5, f"trace phase vs XLA rel-L2 {rel_run:.3e}")


def phase_four_cards(cfg, devices, card: str, log) -> None:
    """The sharded segmented XLA trace on a len(devices) mesh against the
    same trace on a 1-device mesh, and the sharded CBET solve against the
    1-device solve, in one process.  Times are steady (second call)."""
    import numpy as np

    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.models import tileplan as tp
    from cbet_raytracing_3d_tpu.models.cbet import cbet_solve
    from cbet_raytracing_3d_tpu.parallel import sharding as sh
    from cbet_raytracing_3d_tpu.runner import run, trace_fn

    def steady(fn):
        fn()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    n = len(devices)
    mesh1 = sh.make_mesh(devices[:1])
    mesh_n = sh.make_mesh(devices)
    # runner.run takes the fused kernel on one card: the 1-device side of
    # the comparison calls the segmented XLA trace itself
    ctx = rt.prepare_device(cfg)
    plan = tp.get_or_measure_plan(cfg, ctx, ctx.state0, WORK)
    seg1, _ = trace_fn(cfg, mesh1, ctx.layout.rays_per_tile, plan)
    e1, t1 = steady(lambda: np.asarray(seg1(ctx.field4, ctx.state0)[0],
                                       np.float64))
    rf, tf = steady(lambda: run(cfg, mesh=mesh1, verbose=False,
                                cache_dir=WORK))
    rn, tn = steady(lambda: run(cfg, mesh=mesh_n, verbose=False,
                                cache_dir=WORK))
    rel = rel_l2(rn.edep, e1)
    log(f"{n} cards: sharded segmented XLA trace rel-L2 vs the 1-device "
        f"segmented XLA trace {rel:.3e}, vs the 1-card fused trace "
        f"{rel_l2(rn.edep, rf.edep):.3e}")
    log(f"{n} cards: steady Tracing {rn.timings['Tracing']:.4f} s "
        f"(segmented XLA, {n} cards) vs {rf.timings['Tracing']:.4f} s "
        f"(fused Triton, 1 card); segmented XLA trace call {t1:.4f} s on 1 "
        f"card; runner.run wall {tn:.4f} s ({n} cards) vs {tf:.4f} s "
        f"(1 card) [{card}]")
    _check(rn.stats["rays_launched"] == rf.stats["rays_launched"],
           "launched-ray counts differ across meshes")
    _check(rel < 1e-5, f"sharded trace rel-L2 {rel:.3e} >= 1e-5")

    c1 = cbet_solve(cfg, ctx)
    cn = cbet_solve(cfg, ctx, mesh=mesh_n)
    rel_c = rel_l2(cn.edep, c1.edep)
    log(f"{n} cards: sharded CBET {cn.iterations} iterations (1 device "
        f"{c1.iterations}); rel-L2 vs 1 device {rel_c:.3e}; iteration "
        f"seconds {cn.stats['iter_seconds']} on {n} cards vs "
        f"{c1.stats['iter_seconds']} on 1 [{card}]")
    _check(cn.converged and c1.converged, "CBET did not converge")
    _check(rel_c < 1e-4, f"sharded CBET rel-L2 {rel_c:.3e} >= 1e-4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    try:
        sys.path.insert(0, REPO)
        from cbet_raytracing_3d_tpu.utils.compile_cache import (
            enable_persistent_cache)
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})",
              file=sys.stderr)
        return 2
    enable_persistent_cache()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:want]
    from cbet_raytracing_3d_tpu.utils.device import card_line
    card = card_line()

    from cbet_raytracing_3d_tpu.config import Config

    os.makedirs(WORK, exist_ok=True)
    cfg = Config()

    def log(msg: str) -> None:
        print(msg, flush=True)

    log(f"device: {devices[0].device_kind} x{len(devices)} [{card}]")
    phases = ([("four_cards", lambda: phase_four_cards(cfg, devices, card,
                                                       log))]
              if args.four_cards else
              [("trace", None), ("oracle", lambda: phase_oracle(card, log)),
               ("gain", lambda: phase_gain(cfg, card, log)),
               ("cbet", lambda: phase_cbet(card, log)),
               ("composed", None), ("triton", None)])
    edep_ref = None
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            if name == "trace":
                edep_ref = phase_trace(cfg, card, log)
            elif name in ("composed", "triton"):
                _check(edep_ref is not None, "no trace grid to compare with")
                (phase_composed if name == "composed" else phase_triton)(
                    cfg, edep_ref, card, log)
            else:
                fn()
            status = "ok"
        except Exception as e:                  # report, keep going, fail
            failed.append(name)
            status = f"FAILED: {type(e).__name__}: {e}"
        log(f"phase {name}: {status} ({time.perf_counter() - t0:.1f} s wall, "
            f"peak device memory {peak_gib(devices[0]):.2f} GiB) [{card}]")

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
