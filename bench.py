"""Benchmark harness: full OMEGA 60-beam trace + converged CBET solve on the
GPU(s) of this machine.

Prints up to TWO JSON lines; the last is the complete record:
  1. the trace-only line (so a cut-off run still records the primary metric),
  2. the same record extended with the converged-CBET wall clock —
     BASELINE.json's full metric is "ray-steps/sec/chip at OMEGA 60-beam;
     wall-clock to converged CBET gain".

Refuses to run (exit 2) without a GPU; exits 1 when the CBET stage fails.

Metric: nominal ray-steps/sec/chip = (total_rays * nt) / steady trace time —
the reference's own upper-bound work accounting (BASELINE.md: 60 beams x
19,600 rays x <=400 steps; both codes terminate rays early, so the nominal
count is the comparable unit).

Baseline: the reference publishes no numbers and its hardware (2x V100) is
unavailable here.  vs_baseline divides by the midpoint (2.5e8 nominal
ray-steps/s) of the first-principles single-V100 cost model derived in
BASELINE.md ("First-principles reference cost model"): the hot loop
(launch_ray_XZ.cu:207-357) is bound by its 8 contended global f64
atomicAdds per ray-step (1.2e8-5e8 range).  The range is reported
alongside as vs_baseline_range.

Output fields (the last JSON line is the complete record):
  value / vs_baseline / vs_baseline_range — ray-steps/s/chip and its ratio
      to the BASELINE.md sm_70 cost model midpoint (and range endpoints).
  trace_seconds — min of 5 timed full traces, fenced on the overflow
      scalar; trace_seconds_median — the median of the same 5.
  init_seconds — first on-device init (includes its one-time jit compile)
      plus trace-function build; init_steady_seconds — a second on-device
      init (compile amortized).
  tile_plan_seconds — measure-or-load of the static segmentation plan
      (disk-cached per config+scene; several cards only).
  trace_path — "triton" (the fused kernel, one card) or "xla_segmented".
  compile_seconds — first trace call minus the steady trace.
  device / device_kind / devices — JAX platform, device kind and count;
      card — ``nvidia-smi --query-gpu=name,power.limit`` of the card(s).
  cbet_warmup_seconds — solver build + 1-iteration solve (compiles and the
      zero-gain iteration-0 trace that the seed memo lets the measured
      solve skip).
  cbet_wallclock_seconds — the measured converged solve, result fetch
      excluded (cbet_result_fetch_seconds).
  cbet_iter_seconds / cbet_iter0_seconds / cbet_seeded_zero_gain — the
      solve's per-iteration wall clocks and zero-gain start.
  cbet_iterations / cbet_converged / cbet_tol / cbet_history /
  cbet_gain_mode — fixed-point outcome and path.
  cbet_edep_total — energy total of the gain-coupled grid.
  golden_rel_l2 / cbet_golden_rel_l2 — rel-L2 of this run's grids vs the
      committed goldens (artifacts/omega_golden.npz, cbet_golden.npz);
      *_drift flags > 1e-4 (the accuracy bar).
"""

import json
import os
import sys
import time

import jax
import numpy as np

from cbet_raytracing_3d_tpu.utils.compile_cache import enable_persistent_cache

enable_persistent_cache()   # reference analog: nvcc compiles once, at build

from cbet_raytracing_3d_tpu import Config, runner  # noqa: E402
from cbet_raytracing_3d_tpu.models import raytracer as rt  # noqa: E402
from cbet_raytracing_3d_tpu.models import tileplan as tp  # noqa: E402
from cbet_raytracing_3d_tpu.parallel import sharding as sh  # noqa: E402
from cbet_raytracing_3d_tpu.utils.device import card_line  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".cbet_cache")

# Reference single-V100 estimate: midpoint of the 1.2e8-5e8 atomics-bound
# model in BASELINE.md "First-principles reference cost model" (see above).
BASELINE_RAY_STEPS_PER_SEC = 2.5e8
BASELINE_RANGE = (1.2e8, 5.0e8)


def _golden_rel(name: str, edep: np.ndarray) -> dict:
    gold = np.load(os.path.join(REPO, "artifacts", f"{name}.npz"))
    g = gold["edep"].astype(np.float64)
    rel = float(np.linalg.norm(edep - g) / np.linalg.norm(g))
    key = "golden" if name == "omega_golden" else "cbet_golden"
    out = {f"{key}_rel_l2": rel}
    if rel > 1e-4:
        out[f"{key}_drift"] = True
    return out


def main() -> int:
    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    card = card_line()

    cfg = Config()
    t0 = time.perf_counter()
    mesh = sh.make_mesh()
    n_dev = int(np.prod(mesh.devices.shape))
    # on-device init (reference parity: init() is accelerator code,
    # launch_ray_XZ.cu:65-115): the per-ray state is born on the card,
    # live-tile compacted; host work is O(grid + nrays)
    ctx = rt.prepare_device(cfg)
    state0 = sh.pad_rays(ctx.state0, n_dev * ctx.layout.rays_per_tile)
    jax.block_until_ready(state0)
    t_init_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(rt.prepare_device(cfg).state0)
    t_init_steady = time.perf_counter() - t0

    # the trace runner.run uses: the fused Pallas-Triton kernel on one
    # card; the per-device-balanced segmented XLA trace on several (its
    # tile plan is measured once per config+scene and disk-cached)
    fused = n_dev == 1
    t0 = time.perf_counter()
    plan = (None if fused
            else tp.get_or_measure_plan(cfg, ctx, state0, CACHE))
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, dseg = runner.trace_fn(cfg, mesh, ctx.layout.rays_per_tile, plan,
                                fused)
    if dseg is not None:
        state0 = sh.device_major_state(state0, ctx.layout.rays_per_tile,
                                       dseg)
    t_init = t_init_first + (time.perf_counter() - t0)

    t0 = time.perf_counter()
    edep, _, oflow = fn(ctx.field4, state0)[:3]
    jax.device_get(oflow)
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        edep, _, oflow = fn(ctx.field4, state0)[:3]
        jax.device_get(oflow)
        times.append(time.perf_counter() - t0)
    t_trace = min(times)
    rt.check_overflow(int(jax.device_get(oflow)))

    value = cfg.total_rays * cfg.nt / t_trace / n_dev
    edep_np = np.asarray(jax.device_get(edep), np.float64)
    dev = jax.devices()[0]
    out = {
        "metric": "ray_steps_per_sec_per_chip",
        "value": value,
        "unit": "ray-steps/s",
        "vs_baseline": value / BASELINE_RAY_STEPS_PER_SEC,
        "vs_baseline_range": [value / BASELINE_RANGE[1],
                              value / BASELINE_RANGE[0]],
        "trace_seconds": t_trace,
        "trace_seconds_median": sorted(times)[len(times) // 2],
        "init_seconds": t_init,
        "init_steady_seconds": t_init_steady,
        "tile_plan_seconds": t_plan,
        "compile_seconds": t_first - t_trace,
        "trace_path": "triton" if fused else "xla_segmented",
        "device": dev.platform,
        "device_kind": dev.device_kind,
        "devices": n_dev,
        "card": card,
        "rays": cfg.total_rays,
        "nt": cfg.nt,
        "edep_total": float(edep_np.sum()),
        **_golden_rel("omega_golden", edep_np),
    }
    print(json.dumps(out), flush=True)

    # BASELINE config 3's second metric: wall-clock to converged CBET gain
    # (tol = Config.cbet_tol).  A 1-iteration warm-up first absorbs the
    # compiles and the zero-gain iteration-0 trace (Config.
    # cbet_seed_zero_gain memoizes it on the solver).
    try:
        from cbet_raytracing_3d_tpu.models.cbet import cbet_solve

        t0 = time.perf_counter()
        cbet_solve(cfg.replace(cbet_max_iters=1), ctx,
                   mesh=mesh if n_dev > 1 else None)
        out["cbet_warmup_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = cbet_solve(cfg, ctx, mesh=mesh if n_dev > 1 else None)
        t_cbet = time.perf_counter() - t0
        fetch = res.stats["result_fetch_seconds"]
        out.update({
            "cbet_wallclock_seconds": t_cbet - fetch,
            "cbet_result_fetch_seconds": fetch,
            "cbet_iter_seconds": res.stats["iter_seconds"],
            "cbet_iter0_seconds": res.stats["iter0_seconds"],
            "cbet_seeded_zero_gain": res.stats["seeded_zero_gain"],
            "cbet_gain_mode": res.stats["gain_mode"],
            "cbet_iterations": res.iterations,
            "cbet_converged": bool(res.converged),
            "cbet_tol": cfg.cbet_tol,
            "cbet_history": res.history,
            "cbet_edep_total": float(res.edep.sum()),
            **_golden_rel("cbet_golden", res.edep),
        })
    except Exception as e:
        out["cbet_error"] = repr(e)[:200]
        print(json.dumps(out))
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
