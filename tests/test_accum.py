"""PairwiseAccumulator (utils/accum.py): the binary-counter f32 reducer of
runner.run_composed.  The fold must be bit-identical whether the levels
dict arrives in push-created insertion order (uninterrupted run) or rebuilt
sorted-ascending (checkpoint load) — the canonical-order guarantee."""

import jax
import jax.numpy as jnp
import numpy as np

from cbet_raytracing_3d_tpu.utils.accum import PairwiseAccumulator


def _deltas(n, shape=(64,)):
    rng = np.random.default_rng(7)
    return [jnp.asarray(rng.uniform(0.1, 1.0, shape).astype(np.float32))
            for _ in range(n)]


def test_binary_counter_levels():
    acc = PairwiseAccumulator(add=lambda a, b: a + b)
    for d in _deltas(13):
        acc.push(d)
    # 13 = 0b1101 -> levels {0, 2, 3}
    assert sorted(acc.levels) == [0, 2, 3]


def test_fold_bit_identical_across_level_orderings():
    add = jax.jit(lambda a, b: a + b)
    for n in (3, 7, 13, 31):
        deltas = _deltas(n)
        acc = PairwiseAccumulator(add)
        for d in deltas:
            acc.push(d)
        direct = np.asarray(acc.fold())
        # checkpoint loaders rebuild the dict sorted-ASCENDING
        reloaded = {lvl: acc.levels[lvl] for lvl in sorted(acc.levels)}
        resumed = np.asarray(PairwiseAccumulator(add, levels=reloaded).fold())
        np.testing.assert_array_equal(direct, resumed)


def test_fold_empty_is_none():
    assert PairwiseAccumulator(add=lambda a, b: a + b).fold() is None
