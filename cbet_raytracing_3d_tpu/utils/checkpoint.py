"""Checkpoint / resume for long traces (SURVEY.md §5.4 — the reference has
none; runs are one-shot).

A trace checkpoints at scan-chunk granularity: the master deposition grid,
the full ray state, the chunk index, and a config fingerprint are written to
a single ``.npz``.  ``resume`` reconstructs the ray state and continues the
remaining chunks.  Used by ``runner.run_resumable``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..models.raytracer import RayState

FORMAT_VERSION = 2   # v2: checkpoints hold live-tile-subset states


def config_fingerprint(cfg: Config) -> str:
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_checkpoint(path: str, cfg: Config, chunk_index: int,
                    master, state: RayState, oflow: int) -> None:
    """Atomic: writes to a temp file then os.replace, so an interrupt
    mid-write never corrupts the previous good checkpoint."""
    import os
    # .npz suffix so savez writes EXACTLY this name: the old bare '.tmp'
    # made the written-name detection below guess, and a stale external
    # 'path.tmp' file could have been promoted over the fresh checkpoint
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        format_version=FORMAT_VERSION,
        fingerprint=config_fingerprint(cfg),
        chunk_index=chunk_index,
        master=np.asarray(master),
        oflow=int(oflow),
        frac=np.stack([np.asarray(a) for a in state.frac]),
        vel=np.stack([np.asarray(a) for a in state.vel]),
        kick=np.stack([np.asarray(a) for a in state.kick]),
        uray=np.asarray(state.uray),
        uray_init=np.asarray(state.uray_init),
        cell=np.stack([np.asarray(a) for a in state.cell]),
        alive=np.asarray(state.alive),
    )
    os.replace(tmp, path)


COMPOSED_VERSION = 1


def _state_payload(state: RayState) -> dict:
    return dict(
        frac=np.stack([np.asarray(a) for a in state.frac]),
        vel=np.stack([np.asarray(a) for a in state.vel]),
        kick=np.stack([np.asarray(a) for a in state.kick]),
        uray=np.asarray(state.uray),
        uray_init=np.asarray(state.uray_init),
        cell=np.stack([np.asarray(a) for a in state.cell]),
        alive=np.asarray(state.alive),
    )


def _state_from(data) -> RayState:
    return RayState(
        frac=tuple(jnp.asarray(data["frac"][i]) for i in range(3)),
        vel=tuple(jnp.asarray(data["vel"][i]) for i in range(3)),
        kick=tuple(jnp.asarray(data["kick"][i]) for i in range(3)),
        uray=jnp.asarray(data["uray"]),
        uray_init=jnp.asarray(data["uray_init"]),
        cell=tuple(jnp.asarray(data["cell"][i]) for i in range(3)),
        alive=jnp.asarray(data["alive"]),
    )


def save_composed_checkpoint(path: str, fingerprint: str, chunk_index: int,
                             state: RayState, uray_full, alive_full,
                             acc_levels: dict, oflow: int) -> None:
    """Checkpoint of the host-orchestrated composed trace
    (``runner.run_composed``): the (current-segment-compacted) ray state
    AFTER ``chunk_index`` completed chunks, the full-slot uray/alive
    accounting arrays, and the binary-counter pairwise accumulator LEVELS
    (restored level-by-level, so a resumed run's master is bit-identical
    to an uninterrupted one).  Atomic via temp+rename."""
    import os
    tmp = path + ".tmp.npz"
    payload = dict(
        composed_version=COMPOSED_VERSION,
        fingerprint=fingerprint,
        chunk_index=chunk_index,
        oflow=int(oflow),
        uray_full=np.asarray(uray_full),
        alive_full=np.asarray(alive_full),
        acc_levels=np.asarray(sorted(acc_levels), np.int64),
        **_state_payload(state),
    )
    for lvl in sorted(acc_levels):
        payload[f"acc_{lvl}"] = np.asarray(acc_levels[lvl])
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_composed_checkpoint(path: str, fingerprint: str):
    """Returns ``(chunk_index, state, uray_full, alive_full, acc_levels,
    oflow)``; validates the run fingerprint (config + segmentation) so a
    checkpoint can't resume a structurally different run."""
    with np.load(path) as data:
        if int(data["composed_version"]) != COMPOSED_VERSION:
            raise ValueError(
                f"unsupported composed checkpoint version: "
                f"{data['composed_version']}")
        fp = str(data["fingerprint"])
        if fp != fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {fp} does not match this run's "
                f"{fingerprint} (different config/segmentation)")
        acc = {int(lvl): jnp.asarray(data[f"acc_{lvl}"])
               for lvl in data["acc_levels"]}
        return (int(data["chunk_index"]), _state_from(data),
                jnp.asarray(data["uray_full"]),
                jnp.asarray(data["alive_full"]),
                acc, int(data["oflow"]))


def load_checkpoint(path: str, cfg: Config):
    """Returns (chunk_index, master, RayState, oflow); validates the config
    fingerprint so a checkpoint can't silently resume a different run."""
    with np.load(path) as data:
        if int(data["format_version"]) != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version: {data['format_version']}")
        fp = str(data["fingerprint"])
        if fp != config_fingerprint(cfg):
            raise ValueError(
                f"checkpoint config fingerprint {fp} does not match the "
                f"current config {config_fingerprint(cfg)}")
        state = RayState(
            frac=tuple(jnp.asarray(data["frac"][i]) for i in range(3)),
            vel=tuple(jnp.asarray(data["vel"][i]) for i in range(3)),
            kick=tuple(jnp.asarray(data["kick"][i]) for i in range(3)),
            uray=jnp.asarray(data["uray"]),
            uray_init=jnp.asarray(data["uray_init"]),
            cell=tuple(jnp.asarray(data["cell"][i]) for i in range(3)),
            alive=jnp.asarray(data["alive"]),
        )
        return (int(data["chunk_index"]), jnp.asarray(data["master"]),
                state, int(data["oflow"]))

