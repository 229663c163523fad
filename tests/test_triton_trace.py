"""The fused Pallas-Triton trace chunk (ops/triton_trace.py), in interpret
mode on the CPU against the XLA trace.  Interpret mode applies
``atomic_add`` as gather-add-scatter, so these tests run one ray per
program (``block=1``); ``chip`` tests compile the kernel for the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from cbet_raytracing_3d_tpu.config import Config
from cbet_raytracing_3d_tpu.models import raytracer as rt
from cbet_raytracing_3d_tpu.ops import triton_trace as tt


def test_atomic_add_interpret_distinct_indices():
    """atomic_add runs in interpret mode and is exact when one call's
    indices are distinct (every program adds into the whole grid)."""
    def kernel(idx_ref, val_ref, g_in, g_ref):
        del g_in
        plt.atomic_add(g_ref, (idx_ref[...],), val_ref[...])

    n, block, size = 16, 4, 64
    idx = jnp.asarray(np.arange(n) * 3 % size, jnp.int32)
    val = jnp.arange(n, dtype=jnp.float32) + 1.0
    blk = pl.BlockSpec((block,), lambda i: (i,))
    whole = pl.BlockSpec((size,), lambda i: (0,))
    out = pl.pallas_call(
        kernel, grid=(n // block,), in_specs=[blk, blk, whole],
        out_specs=whole, out_shape=jax.ShapeDtypeStruct((size,), jnp.float32),
        input_output_aliases={2: 0}, backend="triton", interpret=True,
    )(idx, val, jnp.ones((size,), jnp.float32))
    want = np.ones(size, np.float32)
    np.add.at(want, np.asarray(idx), np.asarray(val))
    np.testing.assert_array_equal(np.asarray(out), want)


@pytest.fixture(scope="module")
def scene(profiles):
    # chunk_steps=40 leaves a 16-step last chunk (nt=96): both kernels
    cfg = Config(nbeams=2, rays_per_zone=1, nx=24, ny=24, nz=24,
                 chunk_steps=40, dtype="float64")
    ctx = rt.prepare(cfg, profiles)
    return cfg, ctx, rt.select_rays(ctx.state0, ctx.live_slots)


@pytest.mark.parametrize("dtype,bar", [("float64", 1e-12), ("float32", 1e-6)])
def test_triton_trace_interpret_matches_xla(scene, dtype, bar):
    cfg, ctx, s0 = scene
    cfg = cfg.replace(dtype=dtype)
    f4 = ctx.field4.astype(dtype)
    s0 = jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, s0)
    e_x, st_x, _ = jax.jit(rt.make_trace_fn(cfg))(f4, s0)
    e_t, st_t, of = jax.jit(tt.make_trace_fn(cfg, block=1, interpret=True))(
        f4, s0)
    assert int(of) == 0
    e_x, e_t = np.asarray(e_x, np.float64), np.asarray(e_t, np.float64)
    assert np.linalg.norm(e_t - e_x) / np.linalg.norm(e_x) < bar
    np.testing.assert_array_equal(np.asarray(st_t.alive),
                                  np.asarray(st_x.alive))
    for ax in range(3):
        np.testing.assert_array_equal(np.asarray(st_t.cell[ax]),
                                      np.asarray(st_x.cell[ax]))
    np.testing.assert_allclose(np.asarray(st_t.uray), np.asarray(st_x.uray),
                               rtol=bar, atol=0)


def test_triton_trace_block_must_divide_rays(scene):
    cfg, ctx, s0 = scene
    with pytest.raises(ValueError, match="power of two"):
        tt.make_chunk_call(cfg, s0.n, 8, block=3)
    with pytest.raises(ValueError, match="dividing"):
        tt.make_chunk_call(cfg, s0.n + 1, 8, block=2)


@pytest.mark.chip
def test_triton_trace_on_gpu(profiles):
    """Compiled for the card at a real block size: matches the XLA trace."""
    cfg = Config(nbeams=4, rays_per_zone=2, nx=40, ny=40, nz=40)
    ctx = rt.prepare_device(cfg, profiles)
    e_x, _, _ = jax.jit(rt.make_trace_fn(cfg))(ctx.field4, ctx.state0)
    e_t, _, _ = jax.jit(tt.make_trace_fn(cfg))(ctx.field4, ctx.state0)
    e_x, e_t = np.asarray(e_x, np.float64), np.asarray(e_t, np.float64)
    assert np.linalg.norm(e_t - e_x) / np.linalg.norm(e_x) < 1e-5
