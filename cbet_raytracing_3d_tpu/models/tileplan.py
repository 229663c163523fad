"""Static tile-liveness plan for mid-trace compaction.

For a fixed config + scene the per-chunk "has any depositing ray" tile
sets are DETERMINISTIC, which turns mid-trace compaction into a *static*
plan: measure once (a cheap no-deposit pre-trace), cache by config+scene
fingerprint, and let the segmented trace
(raytracer.make_segmented_trace_fn) gather the ray state down to the
surviving tiles at fixed chunk boundaries — every shape static, no host
round-trips inside the trace.

CAUTION — raw per-chunk liveness is NOT monotone: live rays can cross
near-vacuum where the absorption increment is exactly zero for a whole
chunk and deposit again later.  Segment construction therefore uses the
suffix-OR ("is this tile ever active again?"), which is monotone by
construction; consumers of ``plan.chunk_live`` must not assume nesting.
Liveness is alive-OR-depositing (see measure_plan) so compaction never
drops a still-stepping ray.

Measured per-chunk live-tile fractions on the reference OMEGA scene
(chunk_steps=25): 1.0 x3, .86, .82 x3, .64, .31, .05, then all-dead — the
early-exit already skips the dead tail; compaction recovers the ~25% of
gather/state/kernel work spent on dead tiles in the middle chunks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from ..config import Config
from ..utils.checkpoint import config_fingerprint

PLAN_VERSION = 2      # v2: alive-based liveness (see measure_plan)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    chunk_steps: int
    chunk_live: np.ndarray        # (n_chunks, T) bool — tile deposits in chunk


@dataclasses.dataclass(frozen=True)
class Segment:
    """One compaction segment: ``chunks`` scan chunks over ``tiles`` (ids in
    the traced live-tile space); multi-device schedules pad with
    duplicated-but-masked tiles (``valid`` False on pad slots)."""

    chunk_lengths: tuple          # steps per chunk in this segment
    tiles: np.ndarray             # (T_s,) int64, sorted, incl. pad duplicates
    valid: np.ndarray             # (T_s,) bool — False on pad duplicates


# Config fields that cannot alter the no-deposit pre-trace (deposit-stage
# and CBET-solver controls, each gain-free by construction of measure_plan):
# normalized out of the plan cache key so flipping e.g. cbet_relax does not
# force a re-measure.
_PLAN_FREE_FIELDS = ("deposit_batch_steps", "edep_dtype", "cbet_max_iters",
                     "cbet_tol", "cbet_relax", "cbet_gain_mode",
                     "cbet_gain_sliced", "cbet_grid_downsample",
                     "machnum", "ncrossings_mult")


def plan_config_fingerprint(cfg: Config) -> str:
    """config_fingerprint with the liveness-irrelevant fields pinned to
    their defaults (see _PLAN_FREE_FIELDS)."""
    defaults = {f.name: f.default for f in dataclasses.fields(Config)}
    return config_fingerprint(cfg.replace(
        **{n: defaults[n] for n in _PLAN_FREE_FIELDS}))


def scene_fingerprint(ctx) -> str:
    """Config + scene-data fingerprint: the plan is only valid for the exact
    inputs it was measured on (modulo _PLAN_FREE_FIELDS)."""
    h = hashlib.sha256(plan_config_fingerprint(ctx.cfg).encode())
    for a in (ctx.prof.r, ctx.prof.ne, ctx.prof.te, ctx.beam_norm):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def measure_plan(cfg: Config, ctx, state0) -> TilePlan:
    """Measure per-chunk tile liveness with a no-deposit pre-trace of
    ``state0`` (a tile-aligned ray state, e.g. the padded live-tile
    selection the production trace uses).

    Liveness = "any ray ALIVE or depositing" — alive-ness, not just
    deposit activity: a tile whose rays coast through zero-absorption
    cells deposits nothing but its rays are still stepping, and dropping
    it early would freeze their termination state (the plain trace lets
    them exit/terminate).  Alive-based segments keep edep AND the
    final-state accounting (run(track_final_state=True)) exact, at a
    slightly larger kept-tile set."""
    import jax
    import jax.numpy as jnp

    from . import raytracer as rt

    rpt = ctx.layout.rays_per_tile
    T = state0.n // rpt
    dstep = rt.make_deferred_step_fn(cfg)
    chunk = max(1, min(cfg.chunk_steps, cfg.nt))
    n_chunks = -(-cfg.nt // chunk)

    def chunk_live(st, field4):
        def body(carry, _):
            st, live = carry
            # entry-alive is the whole criterion: post-step alive and a
            # nonzero (masked) deposit increment are both strict subsets
            # of it, so a tile is live for this chunk iff any ray enters
            # any of its steps alive
            active = st.alive
            st, _ = dstep(st, field4)
            live = live | active.reshape(T, rpt).any(axis=1)
            return (st, live), None

        (st, live), _ = jax.lax.scan(
            body, (st, jnp.zeros((T,), bool)), None, length=chunk)
        return st, live

    # the final partial chunk is covered by scanning full `chunk` steps per
    # chunk (extra steps on dead rays only widen liveness, never shrink it
    # — safe over-approximation)
    @jax.jit
    def run(field4, st):
        _, lives = jax.lax.scan(
            lambda s, _: chunk_live(s, field4), st, None, length=n_chunks)
        return lives

    lives = np.asarray(jax.device_get(run(ctx.field4, state0)))
    return TilePlan(chunk_steps=chunk, chunk_live=lives)


def segments_fingerprint(segments) -> str:
    """Content hash of everything in a segment schedule that shapes chunk
    step counts and slot layouts (per-segment chunk_lengths, tiles, valid).
    Resuming a checkpoint across ANY change here would misalign slots
    silently, and segment COUNT alone cannot detect a re-measured plan with
    the same count but different boundaries.  runner.run_composed builds
    its resume fingerprint from it."""
    import hashlib
    h = hashlib.sha256()
    for seg in segments:
        h.update(np.asarray(seg.chunk_lengths, np.int64).tobytes())
        h.update(np.asarray(seg.tiles, np.int64).tobytes())
        h.update(np.asarray(seg.valid, np.bool_).tobytes())
    return h.hexdigest()[:16]


def build_segments(plan: TilePlan, nt: int,
                   shrink: float = 0.9, min_tiles: int = 0) -> list[Segment]:
    """Greedy segmentation: start a new segment whenever the live-tile count
    drops below ``shrink`` x the current segment's tile count.

    ``min_tiles``: never split once the NEXT segment would hold fewer tiles
    than this — each extra segment of a host-dispatched run costs one
    chunk-program (re)compile, while a small-tail segment saves little
    compute."""
    chunk = plan.chunk_steps
    n_chunks = -(-nt // chunk)
    last = nt - (n_chunks - 1) * chunk
    lengths = [chunk] * (n_chunks - 1) + [last]
    _check_plan_covers(plan, n_chunks)
    # suffix-OR: a tile is "live from chunk c" if it deposits in ANY chunk
    # >= c.  Raw per-chunk liveness is NOT monotone (rays can cross
    # near-vacuum where the absorption increment is exactly zero for a whole
    # chunk and deposit again later), and segments must be nested subsets.
    live = np.flip(np.logical_or.accumulate(
        np.flip(plan.chunk_live, 0), 0), 0)
    T = live.shape[1]

    segments: list[Segment] = []
    cur_tiles = np.arange(T)
    cur_lengths: list[int] = []
    for c in range(n_chunks):
        tiles_c = np.nonzero(live[c])[0]
        if len(tiles_c) == 0:
            # all-dead tail: the in-scan early exit already skips these
            # chunks; splitting further would only add segments
            tiles_c = cur_tiles[:1]
            if cur_lengths and len(cur_tiles) > 1 and min_tiles <= 1:
                segments.append(_segment(cur_lengths, cur_tiles))
                cur_tiles, cur_lengths = tiles_c, []
            cur_lengths.append(lengths[c])
            continue
        if (cur_lengths and len(tiles_c) < shrink * len(cur_tiles)
                and len(tiles_c) >= min_tiles):
            segments.append(_segment(cur_lengths, cur_tiles))
            cur_tiles, cur_lengths = tiles_c, []
        cur_lengths.append(lengths[c])
    segments.append(_segment(cur_lengths, cur_tiles))
    return segments


def _check_plan_covers(plan: TilePlan, n_chunks: int) -> None:
    """A plan covering fewer chunks than the trace needs means it was
    measured with a different nt/chunk_steps — synthesizing all-live
    liveness for the tail would violate the nested-subset invariant and
    trip a searchsorted assert mid-build instead of saying why."""
    if n_chunks > plan.chunk_live.shape[0]:
        raise ValueError(
            f"tile plan covers {plan.chunk_live.shape[0]} chunks but the "
            f"trace needs {n_chunks} — the plan was measured with a "
            "different nt/chunk_steps; re-measure it "
            "(tileplan.get_or_measure_plan keys on these, so this indicates "
            "a stale or hand-built plan)")


def _segment(lengths, tiles) -> Segment:
    tiles = np.asarray(sorted(tiles), np.int64)
    return Segment(chunk_lengths=tuple(lengths), tiles=tiles,
                   valid=np.ones(len(tiles), bool))


@dataclasses.dataclass(frozen=True)
class DeviceSegments:
    """A per-device-balanced segmented schedule for ``n_dev`` devices.

    Every device executes the SAME segment structure (shard_map traces one
    program), so per-segment tile counts are equalized across devices by
    dup-padding; only the tile *ids* differ per device, and those travel as
    sharded array arguments into the trace.

    ``tiles[s]``/``valid[s]`` are (n_dev, T_s) arrays; ``tiles`` ids are in
    the traced (segment-0, device-local) tile space for s>0 and in the
    GLOBAL tile space for s=0 (the caller orders the initial ray state
    device-major from ``tiles[0]``).  ``tiles_local`` carries every
    segment's ids in the segment-0 device-local space (pad duplicates
    included) — the final-state write-back (track_final_state) needs
    absolute origins, while the segmented gathers need the
    relative-to-previous ``tiles``."""

    chunk_lengths: tuple        # per segment: tuple of scan-chunk lengths
    tiles: tuple                # per segment: (n_dev, T_s) int64
    valid: tuple                # per segment: (n_dev, T_s) bool
    tiles_local: tuple          # per segment: (n_dev, T_s) int64, seg-0-local


def build_device_segments(plan: TilePlan, nt: int,
                          n_dev: int, shrink: float = 0.9) -> DeviceSegments:
    """Partition tiles across devices balanced by lifetime, then build a
    common segment schedule (see DeviceSegments).

    Balancing: tiles sorted by death chunk are dealt round-robin, so every
    device holds a matched mix of short- and long-lived tiles and the
    per-chunk live counts stay within one tile of each other — the
    device-parallel analog of the single-device compaction win."""
    chunk = plan.chunk_steps
    n_chunks = -(-nt // chunk)
    last = nt - (n_chunks - 1) * chunk
    lengths = [chunk] * (n_chunks - 1) + [last]
    _check_plan_covers(plan, n_chunks)
    # suffix-OR liveness (see build_segments): monotone by construction, so
    # per-device segment tile sets are nested
    live = np.flip(np.logical_or.accumulate(
        np.flip(plan.chunk_live, 0), 0), 0)     # (n_chunks_measured, T)
    T = live.shape[1]

    # death chunk per tile (-1 = never deposits)
    any_live = live.any(axis=0)
    death = np.where(any_live, live.shape[0] - 1 -
                     np.argmax(live[::-1], axis=0), -1)
    order = np.argsort(-death, kind="stable")   # long-lived first
    if n_dev > T:
        raise ValueError(
            f"more devices ({n_dev}) than tiles ({T}): shrink the mesh or "
            "trace this scene unsegmented")
    dev_tiles = [np.sort(order[d::n_dev]) for d in range(n_dev)]

    # per-device live tiles per chunk (in each device's local tile list);
    # c < live.shape[0] is guaranteed by _check_plan_covers above
    def live_at(c):
        return [np.nonzero(live[c][dt])[0] for dt in dev_tiles]

    def pad_counts(counts):
        return max(max(counts), 1)

    seg_bounds = [0]
    cur = pad_counts([len(dt) for dt in dev_tiles])   # segment 0 = all tiles
    for c in range(1, n_chunks):
        width = pad_counts([len(x) for x in live_at(c)])
        if width < shrink * cur:
            seg_bounds.append(c)
            cur = width
    seg_bounds.append(n_chunks)

    seg_lengths, seg_tiles, seg_valid, seg_local = [], [], [], []
    prev_locals = None                           # per-device local tile ids
    for si in range(len(seg_bounds) - 1):
        c0, c1 = seg_bounds[si], seg_bounds[si + 1]
        if si == 0:
            # segment 0 covers EVERY device tile (matching the
            # single-device build_segments' arange(T)): never-depositing
            # tiles may still hold LAUNCHED rays, and dropping them here
            # would silently remove those rays from the returned final
            # state (termination/energy accounting)
            locs = [np.arange(len(dt)) for dt in dev_tiles]
        else:
            locs = live_at(c0)                   # device-local indices
        width = pad_counts([len(x) for x in locs])
        tiles_s = np.zeros((n_dev, width), np.int64)
        valid_s = np.zeros((n_dev, width), bool)
        for d in range(n_dev):
            t = locs[d]
            if len(t) == 0:
                # a device with no remaining live tiles still executes the
                # segment (shard_map: one program) — give it a masked tile
                # that is guaranteed to exist in its previous segment
                t = (prev_locals[d][:1] if prev_locals is not None
                     and len(prev_locals[d]) else np.zeros(1, np.int64))
                tiles_s[d, :] = t[0]
            else:
                tiles_s[d, :len(t)] = t
                tiles_s[d, len(t):] = t[0]
                valid_s[d, :len(t)] = True
        if si == 0:
            # report segment-0 ids in the GLOBAL tile space (caller builds
            # the device-major initial state from them); local ids follow
            glob = np.zeros_like(tiles_s)
            for d in range(n_dev):
                glob[d] = dev_tiles[d][tiles_s[d]]
            prev_locals = [tiles_s[d][valid_s[d]] if valid_s[d].any()
                           else tiles_s[d][:1] for d in range(n_dev)]
            tiles_out = glob
        else:
            # ids relative to the PREVIOUS segment's (device-local) order,
            # as the segmented gather expects
            rel = np.zeros_like(tiles_s)
            for d in range(n_dev):
                pv = prev_locals[d]
                pos = np.minimum(np.searchsorted(pv, tiles_s[d]),
                                 len(pv) - 1)
                if not (pv[pos] == tiles_s[d]).all():
                    # raise, not assert: a silent mismatch would gather the
                    # wrong tiles' rays on device d under python -O.
                    # ValueError like segment_gather_rows/_check_plan_covers
                    # — one exception contract for stale-plan conditions.
                    raise ValueError(
                        f"device {d}: segment tiles are not a subset of "
                        "the previous segment's (nested-subset invariant "
                        "broken — stale tile plan?)")
                rel[d] = pos
            prev_locals = [tiles_s[d][valid_s[d]] if valid_s[d].any()
                           else tiles_s[d][:1] for d in range(n_dev)]
            tiles_out = rel
        seg_lengths.append(tuple(lengths[c0:c1]))
        seg_tiles.append(tiles_out)
        seg_valid.append(valid_s)
        seg_local.append(tiles_s.copy())     # seg-0 device-local ids

    return DeviceSegments(chunk_lengths=tuple(seg_lengths),
                          tiles=tuple(seg_tiles), valid=tuple(seg_valid),
                          tiles_local=tuple(seg_local))


def origin_slots(tiles: np.ndarray, valid: np.ndarray, rays_per_tile: int,
                 drop_to: int) -> np.ndarray:
    """Per-slot write-back origins in segment-0 slot space: valid tile t
    owns rows ``t*rpt .. t*rpt+rpt-1``; pad-duplicate (invalid) tiles map
    every row to ``drop_to`` — an out-of-range index for
    ``.at[...].set(mode="drop")`` write-backs, or -1 as a host-side
    sentinel.  ``tiles``/``valid`` may be (T,) or device-batched (D, T);
    the result flattens the trailing (T, rpt) to (..., T*rpt)."""
    o = np.where(valid, tiles, -1)
    slots = o[..., :, None] * rays_per_tile + np.arange(rays_per_tile)
    slots[o < 0, :] = drop_to
    return slots.reshape(*o.shape[:-1], -1)


def segment_gather_rows(prev: Segment, seg: Segment, T: int) -> np.ndarray:
    """Row indices of ``seg.tiles`` in ``prev``'s state layout (which may
    interleave valid and pad rows — e.g. per-beam blocks): a direct
    tile-id -> row map over prev's VALID rows.  Every seg tile must exist
    valid in prev (nested-subset invariant)."""
    rowmap = np.full(T, -1, np.int64)
    rows = np.nonzero(prev.valid)[0]
    rowmap[prev.tiles[prev.valid]] = rows
    pos = rowmap[seg.tiles]
    if (pos < 0).any():
        # raise, not assert: a -1 surviving into the gather would wrap to
        # the LAST row and silently trace the wrong tile under python -O
        raise ValueError(
            f"{int((pos < 0).sum())} segment tiles have no valid row in "
            "the previous segment — the nested-subset invariant is broken "
            "(stale or mismatched tile plan?)")
    return pos


def plan_path(cache_dir: str, fingerprint: str) -> str:
    return os.path.join(cache_dir, f"tileplan_{fingerprint}.npz")


def save_plan(path: str, plan: TilePlan, fingerprint: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # per-pid tmp: concurrent runs sharing a cache dir must not interleave
    # writes into the same tmp file (np.savez appends .npz unless present)
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, version=PLAN_VERSION, fingerprint=fingerprint,
                        chunk_steps=plan.chunk_steps,
                        chunk_live=plan.chunk_live)
    os.replace(tmp, path)


def load_plan(path: str, fingerprint: str) -> TilePlan | None:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if (int(z["version"]) != PLAN_VERSION
                    or str(z["fingerprint"]) != fingerprint):
                return None
            return TilePlan(chunk_steps=int(z["chunk_steps"]),
                            chunk_live=np.asarray(z["chunk_live"]))
    except Exception:
        return None               # corrupt/partial file -> re-measure


def get_or_measure_plan(cfg: Config, ctx, state0,
                        cache_dir: str | None) -> TilePlan:
    n_tiles = state0.n // ctx.layout.rays_per_tile
    # the traced slot layout (tile count) is part of the key: it varies
    # with device count / padding mode, and a plan measured on a different
    # layout would misalign every segmented gather.  The cfg ACTUALLY
    # traced is hashed too — it may differ from ctx.cfg (e.g. another
    # stop_fraction on the same context must not collide with its plan).
    fp = scene_fingerprint(ctx)
    if plan_config_fingerprint(cfg) != plan_config_fingerprint(ctx.cfg):
        fp = hashlib.sha256(
            (fp + plan_config_fingerprint(cfg)).encode()).hexdigest()[:16]
    fp = f"{fp}_t{n_tiles}"
    if cache_dir:
        plan = load_plan(plan_path(cache_dir, fp), fp)
        if (plan is not None
                and plan.chunk_steps == max(1, min(cfg.chunk_steps, cfg.nt))
                # the traced slot LAYOUT (tile count) varies with device
                # count / padding mode; a plan measured on a different
                # layout would misalign every gather
                and plan.chunk_live.shape[1] == n_tiles):
            return plan
    plan = measure_plan(cfg, ctx, state0)
    if cache_dir:
        save_plan(plan_path(cache_dir, fp), plan, fp)
    return plan
