"""Two-process multi-host smoke: each process is one "host" with one CPU
device; gloo TCP collectives over localhost join them.

Run (two shells, or tests/test_multihost.py does it for you):

    python scripts/smoke_multihost.py <process_id> <num_processes> <port>

Each process traces ITS half of a tiny scene through the multi-host entry
(`parallel.multihost.run_sharded_multihost`), then independently recomputes
the whole scene single-device and asserts the psum-combined multi-host grid
matches to f64 round-off.  Prints ``MULTIHOST OK ...`` on success.

SURVEY.md §5.8: the reference's multi-device story cannot leave one machine
(multi_gpu.cpp:3-59 + host sum main.cu:199-210); this demonstrates the
framework's can.
"""
import os
import sys

# one CPU device per process; must be set before jax import
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from cbet_raytracing_3d_tpu.parallel import multihost as mhost  # noqa: E402

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
mhost.initialize_multihost(f"127.0.0.1:{port}", nproc, pid)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from cbet_raytracing_3d_tpu.config import Config  # noqa: E402
from cbet_raytracing_3d_tpu.models import raytracer as rt  # noqa: E402
from cbet_raytracing_3d_tpu.profiles import load_profiles  # noqa: E402

assert jax.process_count() == nproc, (
    f"process group did not form: {jax.process_count()} != {nproc}")

cfg = Config(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
             dtype="float64")
ctx = rt.prepare(cfg, load_profiles(), host_state=True)
rpt = ctx.layout.rays_per_tile

# a few whole live tiles (deterministic on every process)
live_tiles = np.unique(np.asarray(ctx.live_slots) // rpt)
tiles = live_tiles[: 2 * nproc]
idx = (tiles[:, None] * rpt + np.arange(rpt)[None, :]).reshape(-1)
state0 = rt.select_rays(ctx.state0, idx)

mesh = mhost.global_mesh()
edep_mh, _ = mhost.run_sharded_multihost(cfg, ctx.field4, state0, rpt,
                                         mesh=mesh)

# independent single-device reference (local to this process)
edep_1, _, of1 = jax.jit(rt.make_trace_fn(cfg))(
    jax.device_put(ctx.field4, jax.local_devices()[0]),
    jax.tree_util.tree_map(
        lambda x: jax.device_put(np.asarray(x), jax.local_devices()[0]),
        state0))
assert int(np.asarray(jax.device_get(of1.addressable_data(0)))) == 0
edep_1 = np.asarray(jax.device_get(edep_1.addressable_data(0)), np.float64)

num = np.linalg.norm(edep_mh - edep_1)
den = np.linalg.norm(edep_1)
rel = float(num / den) if den else float(num)
assert den > 0, "empty reference grid — scene too small"
assert rel < 1e-12, f"multi-host grid mismatch: rel-L2 {rel}"
print(f"MULTIHOST OK proc={pid}/{nproc} devices={len(jax.devices())} "
      f"edep_total={edep_mh.sum():.17g} rel_l2={rel:.3g}", flush=True)
jax.distributed.shutdown()
