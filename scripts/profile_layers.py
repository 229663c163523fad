"""Per-layer device time at OMEGA width on the GPU, from profiler traces.

Layers: the plain single-device XLA trace (400 steps of row-gather + step
physics + edep scatter), the same trace segmented on the tile plan (the
XLA path ``runner.run`` takes off the GPU), one gain-coupled CBET
iteration trace (adds the gain lookup and the per-beam intensity scatter),
and the CBET gain reduction.  Each layer is compiled and warmed, timed steady (host clock
around ``block_until_ready``, best of 5), then run once inside its own
``jax.profiler.trace`` window; the window's device busy time is the union
of the GPU kernel intervals in the trace, and the top kernels by summed
duration are listed.

    python scripts/profile_layers.py [--out DIR] [--triton]

``--triton`` adds the Pallas-Triton fused trace (ops/triton_trace.py) as a
fourth layer.  Writes ``<DIR>/layers.json`` after each layer; the traces
stay under ``.cbet_cache/profile/<layer>/``.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def device_events(trace_dir: str):
    """(name, start_ns, duration_ns) of every GPU kernel in the trace."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    out, lines = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            # kernel activity lives on the stream lines; the derived
            # "XLA Modules"/"XLA Ops" lines repeat it at coarser grain
            if not line.name.startswith("Stream"):
                continue
            out += [(e.name, e.start_ns, e.duration_ns) for e in evs]
    return out, lines


def summarize(events) -> dict:
    if not events:
        return {"busy_ms": 0.0, "span_ms": 0.0, "kernels": 0, "top": []}
    iv = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by = {}
    for n, _, d in events:
        by[n] = by.get(n, 0.0) + d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
    return {"busy_ms": busy / 1e6, "span_ms": (iv[-1][1] - iv[0][0]) / 1e6,
            "kernels": len(events),
            "top": [(n, d / 1e6) for n, d in top]}


def main() -> int:
    from cbet_raytracing_3d_tpu.utils.compile_cache import (
        enable_persistent_cache)

    enable_persistent_cache()

    import jax
    import jax.numpy as jnp

    from cbet_raytracing_3d_tpu import Config, runner
    from cbet_raytracing_3d_tpu.models import cbet
    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.models import tileplan as tp
    from cbet_raytracing_3d_tpu.parallel import sharding as sh
    from cbet_raytracing_3d_tpu.utils.device import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, ".cbet_cache",
                                                  "profile"))
    ap.add_argument("--triton", action="store_true")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("profile_layers: no GPU", file=sys.stderr)
        return 2
    card = card_line()

    cfg = Config()
    ctx = rt.prepare_device(cfg)
    state0 = ctx.state0
    B, P = cfg.nbeams, cfg.nx * cfg.ny * cfg.nz
    layers = {}

    trace = jax.jit(rt.make_trace_fn(cfg))
    layers["trace_xla"] = lambda: trace(ctx.field4, state0)[0]
    plan = tp.get_or_measure_plan(cfg, ctx, state0,
                                  os.path.join(REPO, ".cbet_cache"))
    seg, _ = runner.trace_fn(cfg, sh.make_mesh(jax.devices()[:1]),
                              ctx.layout.rays_per_tile, plan)
    layers["trace_xla_segmented"] = lambda: seg(ctx.field4, state0)[0]

    solver = cbet._get_solver(cfg, ctx, None)
    rng = np.random.default_rng(0)
    inten = jnp.asarray(rng.random((B, P), np.float32) * 1e14)
    gain = solver.gain_fn(inten)
    layers["gain"] = lambda: solver.gain_fn(inten)
    layers["cbet_iteration_trace"] = lambda: solver.trace(
        ctx.field4, gain, solver.bid, solver.state0)[1]
    if args.triton:
        from cbet_raytracing_3d_tpu.ops import triton_trace
        ttrace = jax.jit(triton_trace.make_trace_fn(cfg))
        layers["trace_triton"] = lambda: ttrace(ctx.field4, state0)[0]

    os.makedirs(args.out, exist_ok=True)
    rec = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "nt": cfg.nt, "rays": cfg.total_rays, "layers": {}}
    for name, fn in layers.items():
        jax.block_until_ready(fn())                       # compile + warm
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        d = os.path.join(REPO, ".cbet_cache", "profile", name)
        with jax.profiler.trace(d):
            jax.block_until_ready(fn())
        events, lines = device_events(d)
        summ = summarize(events)
        summ["wall_s_best_of_5"] = min(times)
        summ["wall_s_all"] = times
        summ["device_lines"] = lines
        rec["layers"][name] = summ
        print(f"{name}: wall {min(times) * 1e3:.3f} ms (best of 5), device "
              f"busy {summ['busy_ms']:.3f} ms over a {summ['span_ms']:.3f} "
              f"ms window, {summ['kernels']} kernels [{card}]", flush=True)
        for n, ms in summ["top"][:6]:
            print(f"    {ms:10.3f} ms  {n[:100]}")
        rec["peak_bytes_in_use"] = jax.devices()[0].memory_stats().get(
            "peak_bytes_in_use", 0)
        with open(os.path.join(args.out, "layers.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
