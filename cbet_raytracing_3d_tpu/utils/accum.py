"""Binary-counter pairwise accumulator — the float64-equivalent f32
master-grid reducer of the composed trace (runner.run_composed).

Chunk deltas are f32 grids; summing hundreds of them naively loses ~3-4
digits.  The binary counter keeps one partial sum per power-of-two level
(log-depth addition tree, <= log2(n_chunks) grids resident), so the
rounding error grows with log2(n_chunks) instead of n_chunks.

The levels dict is the CHECKPOINT REPRESENTATION: save_composed_checkpoint
persists it as-is and the loaders rebuild it
(sorted-ascending).  Because an uninterrupted run's dict carries levels in
push-created insertion order instead, ``fold`` consumes levels in CANONICAL
(descending-level) order — largest partial sums first — so the f32 addition
tree is identical on both paths and resume stays bit-identical even when
3+ levels survive to the final fold.  Reference analog: the
host OpenMP reduction it replaces (main.cu:199-210) sums in one fixed
order for the same reason.
"""

from __future__ import annotations

from typing import Any

import jax

__all__ = ["PairwiseAccumulator"]


class PairwiseAccumulator:
    """One accumulation stream.  ``add`` must be a two-argument jitted sum
    (donating both args is safe and what both callers use: every partial
    lives only inside ``levels``)."""

    def __init__(self, add=None, levels: dict[int, Any] | None = None):
        self.add = add if add is not None else jax.jit(
            lambda a, b: a + b, donate_argnums=(0, 1))
        # level -> partial sum of 2^level chunk deltas
        self.levels: dict[int, Any] = {} if levels is None else levels

    def push(self, delta) -> None:
        """Carry-propagating insert: merge equal-sized partials upward."""
        lvl = 0
        while lvl in self.levels:
            delta = self.add(self.levels.pop(lvl), delta)
            lvl += 1
        self.levels[lvl] = delta

    def fold(self):
        """Collapse to the master grid (None if nothing was pushed), in the
        canonical descending-level order — see module docstring."""
        master = None
        for lvl in sorted(self.levels, reverse=True):
            g = self.levels[lvl]
            master = g if master is None else self.add(master, g)
        return master
