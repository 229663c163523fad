"""Command-line interface.

The reference's only runtime knob is an OpenMP thread count
(``./cbet-gpu [threads]``, main.cu:236-242) with everything else fixed at
compile time (def.cuh).  Here every def.cuh parameter is a flag; subcommands:

* ``run``    — full simulation (optionally with the CBET stage)
* ``dump``   — reference-compatible -D PRINT text dump to stdout
                (Makefile:14-17 golden-test replacement)
* ``track``  — per-step trajectory recording for selected rays (the live
                version of the reference's dormant RAY_TRACKER /
                INTERSECTION diagnostics hooks, def.cuh:26-27)

(The benchmark harness is top-level ``bench.py`` — the driver contract.)

Usage examples::

    python -m cbet_raytracing_3d_tpu.cli run --nbeams 60 --out-dir out \
        --formats npz,hdf5,json
    python -m cbet_raytracing_3d_tpu.cli run --cbet --nbeams 4
    python -m cbet_raytracing_3d_tpu.cli dump > edep.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .config import Config
from .runner import run, write_outputs
from .utils.output import dump_print_format


def _parse_bool(s: str) -> bool:
    """Strict bool parse: an unrecognized value must ERROR, not silently
    become False (--absorption on / --parity Reference class of typo)."""
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected a boolean (true/false/1/0/yes/no/on/off), got {s!r}")


def _parse_bool_or_none(s: str) -> bool | None:
    """Tri-state for ``bool | None`` config fields (None = let the
    resolver decide): 'none'/'auto' keep None, everything else parses
    strictly as a bool."""
    if s.lower() in ("none", "auto"):
        return None
    return _parse_bool(s)


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    import typing

    hints = typing.get_type_hints(Config)
    for f in dataclasses.fields(Config):
        name = "--" + f.name.replace("_", "-")
        hint = hints.get(f.name)
        choices = (typing.get_args(hint)
                   if typing.get_origin(hint) is typing.Literal else None)
        if hint == typing.Optional[bool]:
            # without this branch a 'bool | None' field falls through to
            # the plain-string parser, where '--cbet-gain-rows2 false'
            # becomes the TRUTHY string 'false' — silently inverting the
            # user's intent
            p.add_argument(name, type=_parse_bool_or_none,
                           default=f.default, metavar="BOOL|none")
        elif f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, type=_parse_bool,
                           default=f.default, metavar="BOOL")
        elif isinstance(f.default, int):
            p.add_argument(name, type=int, default=f.default)
        elif isinstance(f.default, float):
            p.add_argument(name, type=float, default=f.default)
        else:
            # Literal-typed fields reject unknown values at parse time
            # (a silently-accepted '--parity Reference' would run a
            # scientifically different model)
            p.add_argument(name, type=str, default=f.default,
                           choices=choices)


def config_from_args(args: argparse.Namespace) -> Config:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(Config)}
    return Config(**kw)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cbet-tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="full simulation")
    _add_config_flags(p_run)
    p_run.add_argument("--cbet", action="store_true",
                       help="run the CBET gain stage")
    p_run.add_argument("--out-dir", default="out")
    p_run.add_argument("--formats", default="npz,json",
                       help="comma list: npz,hdf5,txt,json")
    p_run.add_argument("--quiet", action="store_true")
    p_run.add_argument("--profile-dir", default=None,
                       help="capture a jax.profiler trace of the Tracing phase")
    p_run.add_argument("--cache-dir", default=".cbet_cache",
                       help="prepare-products / tile-plan cache directory "
                            "('' disables)")
    p_run.add_argument("--composed", action="store_true",
                       help="trace-only large-scale composed run "
                            "(runner.run_composed: on-device init + "
                            "host-dispatched segmented compaction + "
                            "pairwise f64-equivalent master, resumable)")
    p_run.add_argument("--checkpoint", default=None, metavar="PATH",
                       help="composed-run checkpoint file (segment-boundary "
                            "+ periodic saves; implies --composed)")
    p_run.add_argument("--resume", action="store_true",
                       help="resume a composed run from --checkpoint "
                            "(bit-identical)")
    p_run.add_argument("--min-tiles", type=int, default=0,
                       help="composed: never split a segment below this "
                            "many tiles (caps per-segment recompiles)")

    p_dump = sub.add_parser("dump", help="-D PRINT compatible dump to stdout")
    _add_config_flags(p_dump)

    p_track = sub.add_parser(
        "track", help="record per-step trajectories of selected rays")
    _add_config_flags(p_track)
    p_track.add_argument(
        "--pairs", required=True,
        help="comma list of beam:ray thread ids, e.g. '0:9800,17:4321'")
    p_track.add_argument("--out", default="out/trajectories.npz",
                         help="npz output path")

    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    # persistent executable cache across processes (reference analog: nvcc
    # compiles once at build time, Makefile:11-12); see the module
    from .utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    if args.cmd == "run":
        composed = args.composed or args.checkpoint or args.resume
        if composed:
            if args.cbet:
                print("--composed is trace-only; run the CBET stage with "
                      "'run --cbet'", file=sys.stderr)
                return 2
            if args.resume and not args.checkpoint:
                print("--resume requires --checkpoint PATH", file=sys.stderr)
                return 2
            from .runner import run_composed
            res = run_composed(
                cfg, min_tiles=args.min_tiles,
                cache_dir=args.cache_dir or None,
                checkpoint_path=args.checkpoint,
                resume=args.resume, verbose=not args.quiet)
        else:
            res = run(cfg, with_cbet=args.cbet, verbose=not args.quiet,
                      profile_dir=args.profile_dir,
                      cache_dir=args.cache_dir or None)
        paths = write_outputs(res, args.out_dir,
                              tuple(args.formats.split(",")))
        if not args.quiet:
            print(json.dumps(res.stats, indent=2))
            for p in paths:
                print(f"wrote {p}", file=sys.stderr)
        return 0

    if args.cmd == "dump":
        res = run(cfg, verbose=False)
        sys.stdout.write(dump_print_format(res.edep))
        return 0

    if args.cmd == "track":
        import os

        from .models.tracker import track_rays
        try:
            pairs = [tuple(int(v) for v in p.split(":"))
                     for p in args.pairs.split(",")]
            if any(len(p) != 2 for p in pairs):
                raise ValueError
        except ValueError:
            print(f"--pairs: expected 'beam:ray,beam:ray,...', "
                  f"got {args.pairs!r}", file=sys.stderr)
            return 2
        try:
            traj = track_rays(cfg, [p[0] for p in pairs],
                              [p[1] for p in pairs])
        except ValueError as e:     # out-of-range ids: same clean error
            print(f"--pairs: {e}", file=sys.stderr)  # path as malformed ones
            return 2
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        traj.save_npz(args.out)
        print(json.dumps({
            "rays": traj.n,
            "launched": int(traj.launched.sum()),
            "steps": traj.steps.tolist(),
            "crossings": traj.crossing_counts().tolist(),
            "out": args.out,
        }, indent=2))
        return 0

    return 1


if __name__ == "__main__":
    raise SystemExit(main())
