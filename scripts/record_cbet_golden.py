"""Record the CBET-stage regression golden on the GPU.

The golden is the converged OMEGA CBET solve (``Config()``) in float64
(x64 enabled: float64 launch state, ray state, deposits, intensity and gain
fields and master grid), so the float32 production solve is checked against
a higher-precision answer, not against itself.  Writes

* ``<out>/cbet_golden.npz`` — the converged gain-coupled (nx+2)^3 edep grid
  as float32 + its float64 total + config identifiers,
* ``<out>/cbet_golden.json`` — SHA256 of the canonical %.17g dump, 8^3
  block-sum digest, iteration history, the rel-L2 of the float32
  production solve against it (chip_smoke.py and bench.py hold that solve
  to 1e-4), and the rel-L2 of the previous golden against it (a
  lower-precision control: a float32 solve whose launch state was computed
  in float32 sits above the bar).

Reference analog: the ``cmp`` golden test (Makefile:14-17) extended to the
CBET stage the reference only reserves capacity for (def.cuh:94-114).

    python scripts/record_cbet_golden.py [--out artifacts] [--tag TAG]
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cbet_raytracing_3d_tpu.utils.compile_cache import (  # noqa: E402
    enable_persistent_cache)

enable_persistent_cache()

import jax  # noqa: E402

from cbet_raytracing_3d_tpu import Config                     # noqa: E402
from cbet_raytracing_3d_tpu.models import raytracer as rt     # noqa: E402
from cbet_raytracing_3d_tpu.models.cbet import cbet_solve     # noqa: E402
from record_omega_golden import digests, rel_l2               # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("refusing: record the golden on the GPU", file=sys.stderr)
        return 1
    cfg = Config()
    res32 = cbet_solve(cfg, rt.prepare_device(cfg))
    cfg64 = Config(dtype="float64")
    with jax.enable_x64(True):
        res = cbet_solve(cfg64, rt.prepare_device(cfg64), verbose=True)
    assert res.converged, res.history
    edep = np.asarray(res.edep, np.float64)
    os.makedirs(args.out, exist_ok=True)
    npz = os.path.join(args.out, "cbet_golden.npz")
    prev = os.path.join(REPO, "artifacts", "cbet_golden.npz")
    rec = {
        "tag": args.tag,
        "device": jax.devices()[0].device_kind,
        "dtype": "float64",
        "edep_total": float(edep.sum()),
        **digests(edep),
        "grid_shape": list(edep.shape),
        "stored_dtype": "float32",
        "iterations": res.iterations,
        "history": [round(h, 5) for h in res.history],
        "float32_solve_rel_l2": rel_l2(res32.edep, edep),
        "float32_solve_iterations": res32.iterations,
        "previous_golden_rel_l2": rel_l2(
            np.load(prev)["edep"], edep) if os.path.exists(prev) else None,
    }
    np.savez_compressed(npz, edep=edep.astype(np.float32),
                        edep_total=np.float64(edep.sum()),
                        nx=cfg.nx, ny=cfg.ny, nz=cfg.nz,
                        rays_per_zone=cfg.rays_per_zone, nt=cfg.nt,
                        cbet_tol=cfg.cbet_tol, cbet_relax=cfg.cbet_relax)
    with open(os.path.join(args.out, "cbet_golden.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
