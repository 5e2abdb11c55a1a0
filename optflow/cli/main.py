"""CLI entry point: ``python -m optflow.cli.main <job.json[.gz]>``.

Reference-compatible with ``optflow <file.json[.gz]>`` (src/optflow.cpp:29-72):
loads the (possibly gzipped) JSON job file and dispatches on ``style``
(1 = batch pair solve; 2 = the average-flow temporal aligner the reference
kept dormant, src/optflow.cpp:180-226 — implemented in align/average_flow).
"""

from __future__ import annotations

import argparse
import os
import sys


def _align_main(argv) -> int:
    """``optflow align <matches.jsonl>`` — global stack alignment from an
    accumulated match store (the in-process replacement for the external
    solve the reference delegates to Render, SURVEY.md §1)."""
    parser = argparse.ArgumentParser(
        prog="optflow align",
        description="global stack alignment from a JSONL match store",
    )
    parser.add_argument("matches", help="JSONL match store (engine sink output)")
    parser.add_argument("--model", choices=("translation", "affine"),
                        default="affine")
    parser.add_argument("--solver", choices=("zblock", "cg"), default="zblock",
                        help="zblock: direct Schur solve (banded-z graphs); "
                        "cg: edge-sharded conjugate gradient")
    parser.add_argument("--block-sections", type=int, default=256)
    parser.add_argument("--out", default="transforms.json",
                        help="output JSON: {groupId: 2x3 affine rows}")
    ns = parser.parse_args(argv)

    import json

    from optflow.sinks.store import JsonlMatchSink

    matches = JsonlMatchSink(ns.matches).read_all()
    if ns.solver == "zblock":
        from optflow.align.zblock import solve_zblock_alignment

        res = solve_zblock_alignment(
            matches, model=ns.model, block_sections=ns.block_sections
        )
    else:
        if ns.model == "affine":
            from optflow.align.global_solve import solve_affine_alignment

            res = solve_affine_alignment(matches)
        else:
            from optflow.align.global_solve import (
                solve_translation_alignment,
            )

            res = solve_translation_alignment(matches)

    out = {
        g: res.transforms[i].tolist() for i, g in enumerate(res.group_ids)
    }
    with open(ns.out, "w") as f:
        json.dump({"model": ns.model, "residual_rms_px": res.residual,
                   "transforms": out}, f, indent=1)
    print(f"aligned {len(res.group_ids)} sections, "
          f"rms residual {res.residual:.4f} px -> {ns.out}")
    return 0


def main(argv=None) -> int:
    from optflow.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "align":
        return _align_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="optflow",
        description="Dense optical flow over image-pair job files",
    )
    parser.add_argument("filename", help="json job file (optionally .gz)")
    parser.add_argument(
        "--no-features",
        action="store_true",
        help="disable feature pre-alignment regardless of job config",
    )
    parser.add_argument(
        "--profile-dir",
        default=os.environ.get("OPTFLOW_PROFILE_DIR") or None,
        help="write a jax.profiler trace of the whole job here (view with "
        "TensorBoard / xprof); also settable via OPTFLOW_PROFILE_DIR",
    )
    ns = parser.parse_args(argv)

    from optflow.core.config import load_job
    from optflow.utils.metrics import profiler_trace

    args = load_job(ns.filename)
    if ns.no_features:
        args["features"] = False

    style = int(args.get("style", 1))
    if style == 1:
        from optflow.engine.features_glue import default_aligner

        with profiler_trace(ns.profile_dir):
            if int(args.get("pair_batch", 1)) > 1:
                from optflow.engine.batch_runner import run_job_batched

                stats = run_job_batched(args, aligner=default_aligner)
            else:
                from optflow.engine.runner import run_job

                stats = run_job(args, aligner=default_aligner)
        if ns.profile_dir:
            print(f"profiler trace written to {ns.profile_dir}")
        print(f"done: {stats}")
        return 0
    if style == 2:
        from optflow.align.average_flow import average_flow_job

        with profiler_trace(ns.profile_dir):
            average_flow_job(args)
        if ns.profile_dir:
            print(f"profiler trace written to {ns.profile_dir}")
        return 0
    print(f"unknown style {style}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
