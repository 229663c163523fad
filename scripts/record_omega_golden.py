"""Record the OMEGA trace regression golden on the GPU.

The golden is the full OMEGA scene traced in float64 (``dtype="float64"``
with x64 enabled), so the float32 production trace (``runner.run(Config())``)
is checked against a higher-precision answer, not against itself.  Writes

* ``<out>/omega_golden.npz`` — the (nx+2)^3 edep grid as float32 + its
  float64 total + config identifiers,
* ``<out>/omega_golden.json`` — SHA256 of the canonical %.17g dump, 8^3
  block-sum digest, and the rel-L2 of the float32 production trace and of
  the previous golden against it.

chip_smoke.py and bench.py hold every float32 production grid to rel-L2
1e-4 against it — the portable analog of the reference's bitwise
``cmp edep_100 truth_100`` golden test (Makefile:14-17; bitwise cmp is not
portable across architectures).

    python scripts/record_omega_golden.py [--out artifacts] [--tag TAG]
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def digests(edep: np.ndarray) -> dict:
    """SHA256 of the canonical dump and of the 8^3 supercell block sums
    (the block digest localizes any future drift)."""
    from cbet_raytracing_3d_tpu.utils.output import dump_print_format

    bs = 8
    gp = np.pad(edep, [(0, (-s) % bs) for s in edep.shape])
    blocks = gp.reshape(gp.shape[0] // bs, bs, gp.shape[1] // bs, bs,
                        gp.shape[2] // bs, bs).sum(axis=(1, 3, 5))
    return {
        "canonical_dump_sha256": hashlib.sha256(
            dump_print_format(edep).encode()).hexdigest(),
        "block8_sums_sha256": hashlib.sha256(blocks.tobytes()).hexdigest(),
    }


def main() -> int:
    from cbet_raytracing_3d_tpu.utils.compile_cache import (
        enable_persistent_cache)

    enable_persistent_cache()

    import jax

    from cbet_raytracing_3d_tpu import Config
    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.runner import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print("refusing: record the golden on the GPU", file=sys.stderr)
        return 1
    cfg = Config()
    edep32 = run(cfg, verbose=False).edep
    with jax.enable_x64(True):
        edep, _ = rt.trace(rt.prepare_device(cfg.replace(dtype="float64")))
    edep = np.asarray(edep, np.float64)
    os.makedirs(args.out, exist_ok=True)
    prev = os.path.join(REPO, "artifacts", "omega_golden.npz")
    rec = {
        "tag": args.tag,
        "device": jax.devices()[0].device_kind,
        "dtype": "float64",
        "edep_total": float(edep.sum()),
        **digests(edep),
        "grid_shape": list(edep.shape),
        "stored_dtype": "float32",
        "float32_trace_rel_l2": rel_l2(edep32, edep),
        "previous_golden_rel_l2": rel_l2(
            np.load(prev)["edep"], edep) if os.path.exists(prev) else None,
    }
    np.savez_compressed(os.path.join(args.out, "omega_golden.npz"),
                        edep=edep.astype(np.float32),
                        edep_total=np.float64(edep.sum()),
                        nx=cfg.nx, ny=cfg.ny, nz=cfg.nz,
                        rays_per_zone=cfg.rays_per_zone, nt=cfg.nt)
    with open(os.path.join(args.out, "omega_golden.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
