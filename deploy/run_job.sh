#!/usr/bin/env bash
# Single-host job wrapper — the equivalent of the reference's
# singularity/janelia_run.sh (one container invocation per job file).
# Usage: deploy/run_job.sh /path/to/job.json[.gz] [extra CLI args]
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m optflow.cli.main "$@"
