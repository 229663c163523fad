"""Golden-file regression — the committed analog of the reference's
``make test`` (Makefile:14-17), whose ``truth_100`` blob is missing from the
snapshot (.MISSING_LARGE_BLOBS).  The golden here is BASELINE config 1
(single beam, ~100 rays, no CBET) generated by the float64 oracle
(tests/golden/config1_oracle.npz) and compared at tolerance instead of
bitwise ``cmp`` — portable across architectures and dtypes.

Regenerate (only if the physics intentionally changes) with the snippet in
the git history of this file.
"""

import os

import jax
import numpy as np

from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models import raytracer as rt

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "config1_oracle.npz")


def _cfg():
    return Config(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                  dtype="float64")


def test_config1_matches_committed_golden(profiles):
    data = np.load(GOLDEN)
    want = data["edep"]
    rays = data["rays"]

    cfg = _cfg()
    ctx = rt.prepare(cfg, profiles)
    slots = ctx.layout.slot_of[0, rays]
    state0 = rt.select_rays(ctx.state0, slots)
    edep, _, oflow = jax.jit(
        rt.make_trace_fn(cfg))(ctx.field4, state0)
    assert int(oflow) == 0
    got = np.asarray(edep, np.float64)

    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 1e-9, rel_l2
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-10)
