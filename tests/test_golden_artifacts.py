"""Integrity of the committed OMEGA regression goldens.

chip_smoke.py and bench.py compare every GPU run's grids against
``artifacts/omega_golden.npz`` (trace) and ``artifacts/cbet_golden.npz``
(converged CBET), both recorded in float64 — the portable analog of the
reference's bitwise ``cmp edep_100 truth_100`` golden test (Makefile:14-17).
A corrupt, truncated, or config-mismatched artifact would make that
comparison silently vacuous (bench skips on shape mismatch), so CI
validates the artifacts themselves: they load, carry the OMEGA config
identifiers, and their stored f64 totals match the stored f32 grids to
f32-summation accuracy.
"""

import json
import os

import numpy as np
import pytest

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts")

CASES = [
    ("omega_golden", 1.551034500242857e18),
    ("cbet_golden", 1.6517506377461975e18),
]


@pytest.mark.parametrize("name,total", CASES, ids=[c[0] for c in CASES])
def test_golden_artifact_integrity(name, total):
    npz_path = os.path.join(ART, f"{name}.npz")
    jsn_path = os.path.join(ART, f"{name}.json")
    if not os.path.exists(npz_path):
        pytest.skip(f"{name}.npz not recorded yet")
    g = np.load(npz_path)
    edep = g["edep"]
    # OMEGA default config: 100^3 grid -> (nx+2)^3 output
    assert edep.shape == (102, 102, 102)
    assert edep.dtype == np.float32
    assert int(g["nx"]) == 100 and int(g["nt"]) == 400
    assert int(g["rays_per_zone"]) == 4
    assert np.isfinite(edep).all()
    # interior nodes are non-negative; the ghost layer may carry the
    # reference's negative extrapolated weights of boundary-exit steps
    # (launch_ray_XZ.cu:319-356), which the scatter deposit reproduces
    assert (edep[1:-1, 1:-1, 1:-1] >= 0).all()
    # the stored f64 total is the recorder's f64 sum; the f32 grid must
    # reproduce it to f32-summation accuracy (and match this test's
    # committed constant — the round-over-round drift anchor)
    stored = float(g["edep_total"])
    assert abs(stored - total) / total < 1e-12
    assert abs(float(edep.astype(np.float64).sum()) - stored) / stored < 1e-6

    with open(jsn_path) as f:
        rec = json.load(f)
    assert rec["grid_shape"] == [102, 102, 102]
    assert abs(rec["edep_total"] - stored) / stored < 1e-12
    for key in ("canonical_dump_sha256", "block8_sums_sha256"):
        assert len(rec[key]) == 64
