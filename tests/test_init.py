"""Ray initialization tests: closed-form launch lattice, permutation,
rotations, pupil mask, and launch energies vs the literal oracle
(launch_ray_XZ.cu:65-115)."""

import numpy as np
import pytest

from cbet_raytracing_3d_tpu.beams import (init_rays, load_beam_norms,
                                          power_table, ray_permutation)
from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models.raytracer import initial_cell
from cbet_raytracing_3d_tpu.oracle import oracle_init


def test_beam_table_shape_and_unit_norm():
    bn = load_beam_norms()
    assert bn.shape == (60, 3)
    norms = np.linalg.norm(bn, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-7)


def test_permutation_is_bijection():
    cfg = Config()
    perm = ray_permutation(cfg, np.arange(cfg.nrays))
    assert sorted(perm.tolist()) == list(range(cfg.nrays))


def test_init_matches_oracle():
    cfg = Config()
    bn = load_beam_norms()
    pow_r = power_table(cfg)
    phase_r = np.linspace(0.0, cfg.pow_table_max, cfg.pow_table_len)
    rays = init_rays(cfg, bn, pow_r)
    rng = np.random.default_rng(7)
    for _ in range(40):
        b = int(rng.integers(0, cfg.nbeams))
        rr = int(rng.integers(0, cfg.nrays))
        ok, x, y, z, uray = oracle_init(cfg, b, rr, bn, pow_r, phase_r)
        assert bool(rays.mask[b, rr]) == ok
        # closed-form lattice vs the reference's repeated addition: equal to
        # float64 roundoff (the reference's own commented intent,
        # launch_ray_XZ.cu:82,91)
        np.testing.assert_allclose(rays.pos[b, rr], [x, y, z], rtol=0, atol=1e-12)
        np.testing.assert_allclose(rays.uray[b, rr], uray, rtol=1e-12)


def test_pupil_mask_fraction():
    cfg = Config()
    rays = init_rays(cfg, load_beam_norms(), power_table(cfg))
    frac = rays.mask[0].mean()
    # circle inscribed in the square launch lattice: ~pi/4 acceptance
    assert 0.70 < frac < 0.82


def test_reference_parity_truncation_is_inert():
    """The reference silently drops thread ids >= 19456 per beam via launch
    grid truncation (main.cu:161, def.cuh:127-129).  It turns out those 144
    thread ids all permute to lattice sites *outside* the circular pupil
    (ref > 450 um), which the kernel would skip anyway — so reference-parity
    mode and clean mode launch the identical ray set."""
    cfg = Config(parity="reference")
    assert cfg.traced_rays_per_beam == 19456
    rays = init_rays(cfg, load_beam_norms(), power_table(cfg))
    clean = init_rays(Config(), load_beam_norms(), power_table(Config()))
    # the truncated ids are pupil-rejected in clean mode too
    assert not clean.mask[0, cfg.traced_rays_per_beam:].any()
    assert (rays.mask == clean.mask).all()


def test_initial_cell_matches_literal_scan():
    cfg = Config()
    rng = np.random.default_rng(3)
    t = np.concatenate([
        rng.uniform(-2, cfg.nx + 1, size=(300, 3)),
        np.round(rng.uniform(0, cfg.nx - 1, size=(50, 3))) + 0.5001,  # knife edges
        np.round(rng.uniform(0, cfg.nx - 1, size=(50, 3))) - 0.4999,
    ])
    got = initial_cell(cfg, t)
    # literal transcription of launch_ray_XZ.cu:162-183 in grid units
    for row_t, row_c in zip(t, got):
        for ax, n in enumerate((cfg.nx, cfg.ny, cfg.nz)):
            want = 0
            for xx in range(n):
                if abs(xx - row_t[ax]) <= 0.5001:
                    want = xx
                    break
            assert row_c[ax] == want


@pytest.mark.parametrize("dtype,rtol,atol,rtol_u",
                         [("float64", 1e-10, 1e-13, 1e-12),
                          ("float32", 0.0, 0.0, 0.0)])
def test_device_init_matches_host_prepare(profiles, dtype, rtol, atol,
                                          rtol_u):
    """On-device ray init (raytracer.prepare_device — the analog of the
    reference's GPU-side init(), launch_ray_XZ.cu:65-115) must reproduce
    the host-NumPy prepare: same live slots, same state values, same
    traced deposition.  Both do the launch arithmetic in float64 and round
    once, so a float32 state agrees bit for bit (float32 arithmetic at grid
    coordinates of ~nx would leave ~1e-6 cells in ``frac`` and double a
    float32 trace's distance from the float64 trace)."""
    import jax
    from cbet_raytracing_3d_tpu.models import raytracer as rt

    cfg = Config(nbeams=3, rays_per_zone=2, nx=40, ny=40, nz=40,
                 dtype=dtype)
    ctx_h = rt.prepare(cfg, profiles)
    ctx_d = rt.prepare_device(cfg, profiles)

    # both layouts are the live tiles in beam-major order
    state_h = rt.select_rays(ctx_h.state0, ctx_h.live_slots)
    state_d = ctx_d.state0
    assert state_d.n == state_h.n
    launched_h = np.asarray(state_h.alive)
    launched_d = np.asarray(state_d.alive)
    np.testing.assert_array_equal(launched_d, launched_h)
    m = launched_h
    for ax in range(3):
        # cells must match exactly (integer); float state to ulp-level
        # tolerance (XLA and NumPy associate a few expressions differently)
        np.testing.assert_array_equal(
            np.asarray(state_d.cell[ax])[m], np.asarray(state_h.cell[ax])[m])
    for name in ("frac", "vel", "kick"):
        for ax in range(3):
            a_h = np.asarray(getattr(state_h, name)[ax])[m]
            a_d = np.asarray(getattr(state_d, name)[ax])[m]
            assert a_d.dtype == a_h.dtype
            np.testing.assert_allclose(a_d, a_h, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{ax}]")
    np.testing.assert_allclose(np.asarray(state_d.uray)[m],
                               np.asarray(state_h.uray)[m], rtol=rtol_u)

    fn = jax.jit(rt.make_trace_fn(cfg))
    e_h, _, _ = fn(ctx_h.field4, state_h)
    e_d, _, _ = fn(ctx_d.field4, state_d)
    # ulp-level launch-state differences propagate through 400 steps of
    # chaotic-adjacent dynamics; 1e-8 is still 4 orders under the 1e-4 bar
    np.testing.assert_allclose(np.asarray(e_d), np.asarray(e_h),
                               rtol=1e-6, atol=1e-8 * float(
                                   np.asarray(e_h).max()))


def test_device_init_fn_is_cached():
    """make_device_init must return the SAME jitted callable for equal
    (cfg, layout): a fresh jax.jit wrapper per call forces a re-trace and
    re-compile on every steady-state prepare_device."""
    from cbet_raytracing_3d_tpu.models import raytracer as rt

    cfg = Config(nbeams=2, rays_per_zone=2, nx=24, ny=24, nz=24)
    lay = rt.build_tile_layout(cfg, with_slots=False)
    fn1 = rt.make_device_init(cfg, lay)
    fn2 = rt.make_device_init(cfg, rt.build_tile_layout(cfg, with_slots=False))
    assert fn1 is fn2
    # a different config must NOT hit the same cache entry
    cfg2 = Config(nbeams=2, rays_per_zone=2, nx=26, ny=26, nz=26)
    fn3 = rt.make_device_init(cfg2, rt.build_tile_layout(cfg2, with_slots=False))
    assert fn3 is not fn1

