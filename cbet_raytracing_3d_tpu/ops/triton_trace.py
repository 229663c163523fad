"""Fused trace chunk for NVIDIA GPUs: one Pallas kernel through Triton.

The reference runs one CUDA thread per ray through the whole time loop and
deposits each step's 8 trilinear corners with global ``atomicAdd``
(launch_ray_XZ.cu:117-359, :319-348).  This kernel is that design in
Pallas: each program owns ``block`` consecutive rays (a power of two, part
of one launch tile), keeps their structure-of-arrays state in registers
across a loop over one ``chunk_steps`` chunk, gathers each step's
``field4`` row, and adds the 8 corners with ``atomic_add`` into the
float32 chunk grid.  A program whose rays are all dead stops stepping.  The
physics is ``raytracer.make_deferred_step_fn`` itself (with a gather that
reads the flattened field table from the kernel reference) and the corners
are ``raytracer.corner_parts``, so the kernel cannot drift from the XLA
trace.  Between chunks the grid is promoted into the master exactly as
``raytracer.make_trace_fn`` does.

``interpret=True`` runs it on the CPU for tests.  The interpreter applies
``atomic_add`` as gather-add-scatter, which loses colliding updates inside
one call, so interpret-mode tests use ``block=1`` (one ray per program:
its 8 corners are distinct nodes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import Config
from ..models import raytracer as rt

#: per-ray state arrays in kernel order; alive travels as int32
_N_STATE = 15


def _flatten(state: rt.RayState) -> list:
    return [*state.frac, *state.vel, *state.kick, state.uray,
            state.uray_init, *state.cell, state.alive.astype(jnp.int32)]


def _unflatten(a) -> rt.RayState:
    return rt.RayState(frac=tuple(a[0:3]), vel=tuple(a[3:6]),
                       kick=tuple(a[6:9]), uray=a[9], uray_init=a[10],
                       cell=tuple(a[11:14]), alive=a[14] != 0)


def _gather_flat(f_ref, flat):
    """The step's (kick_x, kick_y, kick_z, absorb) from the flattened
    (P*4,) field table."""
    base = flat * 4
    return tuple(f_ref[base + c] for c in range(4))


def make_chunk_call(cfg: Config, n_rays: int, n_steps: int, block: int,
                    interpret: bool = False):
    """``(field4_flat (4P,), state arrays (15 x (n_rays,)), grid (G,)) ->
    (state arrays, grid)``: advance every ray ``n_steps`` steps, adding
    the deposits into ``grid`` (the ghost-padded chunk grid, flattened).
    State and grid are updated in place (aliased)."""
    if block & (block - 1) or n_rays % block:
        raise ValueError(f"block {block} must be a power of two dividing "
                         f"the ray count {n_rays}")
    dstep = rt.make_deferred_step_fn(cfg, gather=_gather_flat)

    def kernel(f_ref, *refs):
        ins, outs = refs[:_N_STATE], refs[_N_STATE + 1:2 * _N_STATE + 1]
        grid_ref = refs[-1]
        st = _unflatten([r[...] for r in ins])

        def cond(carry):
            i, st = carry
            return (i < n_steps) & (jnp.max(st.alive.astype(jnp.int32)) > 0)

        def body(carry):
            i, st = carry
            st, (cell, frac, inc) = dstep(st, f_ref)
            for idx, val in rt.corner_parts(cfg, cell, frac, inc):
                plt.atomic_add(grid_ref, (idx,), val)
            return i + 1, st

        _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
        for r, a in zip(outs, _flatten(st)):
            r[...] = a

    def call(field4_flat, state_arrays, grid):
        blk = pl.BlockSpec((block,), lambda i: (i,))
        whole_f = pl.BlockSpec(field4_flat.shape, lambda i: (0,))
        whole_g = pl.BlockSpec(grid.shape, lambda i: (0,))
        out = pl.pallas_call(
            kernel,
            grid=(n_rays // block,),
            in_specs=[whole_f] + [blk] * _N_STATE + [whole_g],
            out_specs=[blk] * _N_STATE + [whole_g],
            out_shape=[jax.ShapeDtypeStruct(a.shape, a.dtype)
                       for a in state_arrays]
            + [jax.ShapeDtypeStruct(grid.shape, grid.dtype)],
            input_output_aliases={1 + k: k for k in range(_N_STATE + 1)},
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
            interpret=interpret,
            name="trace_chunk",
        )(field4_flat, *state_arrays, grid)
        return list(out[:_N_STATE]), out[-1]

    return call


def _pad(arrs, n_pad: int) -> list:
    """Pad the ray axis with dead rays (uray_init 1 keeps the stop rule
    defined)."""
    return [jnp.pad(a, (0, n_pad), constant_values=1 if k == 10 else 0)
            for k, a in enumerate(arrs)]


def make_trace_fn(cfg: Config, block: int = 128, interpret: bool = False):
    """Drop-in for ``raytracer.make_trace_fn`` on one GPU:
    ``(field4, state0) -> (edep, final_state, overflow)``.  The ray axis is
    padded with dead rays to a multiple of ``block`` inside; atomics never
    drop a deposit, so ``overflow`` is 0."""
    chunk = max(1, min(cfg.chunk_steps, cfg.nt))
    n_chunks = -(-cfg.nt // chunk)
    last_chunk = cfg.nt - (n_chunks - 1) * chunk
    g_size = cfg.edep_shape[0] * cfg.edep_shape[1] * cfg.edep_shape[2]

    def trace(field4, state0: rt.RayState):
        n0 = state0.n
        n_pad = -n0 % block
        n = n0 + n_pad
        run_full = make_chunk_call(cfg, n, chunk, block, interpret)
        run_last = make_chunk_call(cfg, n, last_chunk, block, interpret)
        f_flat = field4.reshape(-1)

        def chunk_body(carry, steps_in_chunk):
            arrs, master = carry
            grid = jnp.zeros((g_size,), arrs[9].dtype)

            def run_chunk():
                if last_chunk == chunk:
                    return run_full(f_flat, arrs, grid)
                return jax.lax.cond(steps_in_chunk == chunk,
                                    lambda: run_full(f_flat, arrs, grid),
                                    lambda: run_last(f_flat, arrs, grid))

            # all-dead chunks are skipped, as in the XLA trace
            arrs, grid = jax.lax.cond(jnp.any(arrs[14] != 0), run_chunk,
                                      lambda: (arrs, grid))
            master = master + grid.reshape(cfg.edep_shape).astype(
                master.dtype)
            return (arrs, master), None

        master = jnp.zeros(cfg.edep_shape, rt.master_dtype(cfg))
        steps = jnp.asarray([chunk] * (n_chunks - 1) + [last_chunk],
                            jnp.int32)
        (arrs, master), _ = jax.lax.scan(
            chunk_body, (_pad(_flatten(state0), n_pad), master), steps)
        return master, _unflatten([a[:n0] for a in arrs]), jnp.int32(0)

    return trace
