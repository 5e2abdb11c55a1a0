#!/usr/bin/env python
"""Multi-host launcher.

The reference scales by launching independent Singularity containers per
job file on an LSF cluster (singularity/janelia_run.sh; SURVEY.md §1 L6).
This launcher runs ONE logical job across several hosts: every host starts
this script, they join through jax.distributed, build a global
(pairs, rows) mesh, and the pair scheduler shards the job's pair list
across all hosts' devices.

Coordinator settings come from flags, or from JAX_COORDINATOR_ADDRESS
when the cluster environment provides it.

Usage (per host):
  python deploy/run_pod.py job.json.gz \
      [--coordinator host:port --num-processes N --process-id I]
"""

from __future__ import annotations

import argparse
import os
import sys

# The script is launched by path (one exec per host), so sys.path[0]
# is deploy/ — make the checkout importable when the package isn't
# pip-installed (mirrors the reference container's exec-from-anywhere
# runscript, singularity/optflow.def:48-49).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("filename")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--rows-axis", type=int, default=1,
                        help="devices per image (spatial tiling); the rest "
                             "go to the pairs axis")
    parser.add_argument("--platform", default=None,
                        help="force a jax platform (e.g. cpu for the "
                             "multi-process CPU test harness)")
    ns = parser.parse_args(argv)

    import jax

    import os

    from optflow.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if ns.platform:
        jax.config.update("jax_platforms", ns.platform)

    if ns.coordinator or ns.num_processes:
        jax.distributed.initialize(
            coordinator_address=ns.coordinator,
            num_processes=ns.num_processes,
            process_id=ns.process_id,
        )
    elif os.environ.get("JAX_COORDINATOR_ADDRESS"):
        # cluster-provided coordinator; only attempted when the env is
        # present (an unconditional initialize() fails on a single host)
        jax.distributed.initialize()

    from optflow.core.config import load_job
    from optflow.engine.batch_runner import run_job_batched
    from optflow.engine.features_glue import default_aligner

    args = load_job(ns.filename)
    # Pair solving is embarrassingly parallel (the reference scales the
    # same way: independent 5000-pair job files, gen_cross_file_list.py:
    # 26-27). Each host takes a round-robin slice of the image list and
    # solves it on a mesh over its LOCAL devices — hosts never join a
    # global jit for the pair loop, so their pair subsets may differ
    # freely. jax.distributed supplies the rendezvous (and the global mesh
    # for any subsequent alignment solve, which IS one global program).
    n_proc = jax.process_count()
    pid = jax.process_index()
    mesh = None
    if n_proc > 1:
        from optflow.dist.mesh import make_pair_mesh

        args["images"] = args.get("images", [])[pid::n_proc]
        if args.get("journal"):
            args["journal"] = f"{args['journal']}.{pid}"
        mesh = make_pair_mesh(devices=jax.local_devices())

    stats = run_job_batched(args, aligner=default_aligner, mesh=mesh)
    print(f"[host {pid}/{n_proc}] done: {stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
