"""The GPU-only entry points (chip_smoke.py, bench.py) refuse to run
without a GPU — they never fall back to the CPU — and chip_smoke.py needs
the repository beside it.  Their GPU phases are ``chip`` tests here."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"],
                                  ["bench.py"]])
def test_refuses_without_gpu(args):
    out = _run(args, REPO)
    assert out.returncode != 0
    assert out.stdout == ""            # no result line
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "repository" in out.stderr


@pytest.mark.chip
def test_chip_oracle_phase():
    """The config-1 scene against the float64 oracle on the card."""
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.phase_oracle("", print)


def test_chip_smoke_gain_reference(profiles):
    """chip_smoke's float64 NumPy gain reference (built from the scene
    tables, not from models/cbet.py) agrees with the XLA gain reduction on
    a small grid — the check its gain phase makes at OMEGA width."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    import chip_smoke
    from cbet_raytracing_3d_tpu.config import Config
    from cbet_raytracing_3d_tpu.models import raytracer as rt
    from cbet_raytracing_3d_tpu.models.cbet import make_gain_fn

    cfg = Config(nx=16, ny=16, nz=16)
    ctx = rt.prepare(cfg, profiles)
    B, P = cfg.nbeams, cfg.nx * cfg.ny * cfg.nz
    rng = np.random.default_rng(3)
    inten = (rng.random((B, P)) * 1e14).astype(np.float32)
    g = np.asarray(make_gain_fn(cfg, ctx)(jnp.asarray(inten)), np.float64)
    cols = rng.choice(P, 512, replace=False)
    ref, scale = chip_smoke.gain_reference(cfg, inten, cols)
    assert np.abs(ref).max() > 0
    err = np.abs(g[:, cols] - ref) / np.maximum(scale, 1e-300)
    assert err.max() < 1e-5, err.max()
