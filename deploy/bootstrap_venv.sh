#!/usr/bin/env bash
# Clean-environment install + smoke run — the validation layer for the
# container recipe (optflow.def). The def file's %post is: install
# deps, `pip install` this repo, prebuild the native loader; its
# %runscript is `optflow job.json.gz`. This script performs the same
# sequence against an isolated install prefix and runs a real job
# through the INSTALLED package (not the source tree), so packaging
# bugs (missing modules in pyproject, broken entry point, native build
# failure) surface here.
#
# Network-free: the heavyweight deps (jax, numpy) come from the running
# environment (the container gets them via pip with network); the repo
# itself is built into a wheel and installed with --no-deps --no-index,
# which is the part the recipe must prove.
#
# Usage: bash deploy/bootstrap_venv.sh [workdir]
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
WORK="${1:-$(mktemp -d)}"
mkdir -p "$WORK"
echo "== optflow install smoke =="
echo "repo: $REPO  work: $WORK"

echo "-- build wheel (validates pyproject + sdist/wheel packaging)"
pip wheel --no-build-isolation --no-deps -w "$WORK/dist" "$REPO" 2>&1 | tail -1
WHEEL="$(ls "$WORK"/dist/optflow-*.whl)"
echo "wheel: $WHEEL"

echo "-- install into isolated prefix (no network, no deps)"
pip install --no-index --no-deps --target "$WORK/install" "$WHEEL" 2>&1 | tail -1

echo "-- entry point + import location"
test -d "$WORK/install/optflow"
cd "$WORK"  # keep the repo source tree off sys.path[0]
PYTHONPATH="$WORK/install" python - "$WORK" <<'EOF'
import sys
import optflow
work = sys.argv[1]
print("package at", optflow.__file__)
assert optflow.__file__.startswith(f"{work}/install"), \
    "imported from source tree, not the install"
# console entry point declared and resolvable
import importlib.metadata as md
eps = md.distribution("optflow").entry_points
console = [e for e in eps if e.group == "console_scripts"]
assert any(e.name == "optflow" for e in console), console
print("console_scripts:", [(e.name, e.value) for e in console])
EOF

echo "-- native loader build (container %post step)"
make -C "$WORK/install/optflow/native" 2>&1 | tail -1 \
    || echo "native build skipped (toolchain optional)"

echo "-- end-to-end job through the installed package (CPU)"
PYTHONPATH="$WORK/install" python - "$WORK" <<'EOF'
import json, os, sys
import numpy as np
import scipy.ndimage as ndi
from optflow.core.imgio import write_png
work = sys.argv[1]
os.makedirs(f"{work}/imgs", exist_ok=True)
os.makedirs(f"{work}/out", exist_ok=True)
rng = np.random.default_rng(0)
base = ndi.gaussian_filter(rng.standard_normal((64, 96)), 2.0)
im0 = ((base - base.min()) / np.ptp(base) * 215 + 20).astype(np.uint8)
im1 = np.roll(im0, 1, axis=1)
write_png(f"{work}/imgs/a.png", im0)
write_png(f"{work}/imgs/b.png", im1)
job = {
    "style": 1, "scale": 1.0, "output_type": "flow",
    "output_dir": f"{work}/out",
    "nscales": 2, "warps": 2, "iterations": 30,
    "images": [{"p": f"{work}/imgs/a.png", "q": f"{work}/imgs/b.png",
                "output_name": "ab"}],
}
with open(f"{work}/job.json", "w") as f:
    json.dump(job, f)
EOF
PYTHONPATH="$WORK/install" python - "$WORK/job.json" <<'EOF'
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from optflow.cli.main import main
raise SystemExit(main([sys.argv[1]]))
EOF

test -f "$WORK/out/ab_1.00_x.tiff" && test -f "$WORK/out/ab_1.00_y.tiff"
echo "-- outputs present:"
ls -la "$WORK/out/"
echo "== SMOKE PASSED =="
