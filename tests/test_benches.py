"""The measurement scripts off the GPU, and bench_levels' reductions.

Every bench refuses a non-GPU backend with a non-zero exit and prints no
result; bench_levels' trace reduction, HLO byte count and level chain are
checked at tiny sizes on the CPU (their times are not device numbers)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_levels  # noqa: E402
from optflow.core.config import TVL1Params  # noqa: E402
from optflow.ops.pyramid import pyramid_shapes  # noqa: E402


@pytest.mark.parametrize("script", [
    "bench.py", "bench_job.py", "bench_levels.py", "bench_matrix.py",
    "bench_scaling.py",
])
def test_bench_refuses_cpu_backend(script, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert "{" not in r.stdout


@pytest.mark.parametrize("spans, busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 25)], 15),           # disjoint
    ([(0, 10), (5, 12)], 12),            # overlapping
    ([(0, 10), (2, 4), (3, 9)], 10),     # nested
    ([(20, 25), (0, 10), (10, 20)], 25),  # unsorted, touching
])
def test_busy_union(spans, busy):
    assert bench_levels.busy_ns(spans) == busy


def test_iteration_bytes_cover_the_least_traffic():
    rec = bench_levels.iteration_bytes(2, (24, 40))
    assert (rec["hlo_bytes_per_px_iter"]
            >= bench_levels.MIN_BYTES_PER_PX_ITER)
    assert rec["hlo_flops_per_px_iter"] > 0


def test_level_times_walk_the_pyramid():
    params = TVL1Params(nscales=3, warps=1, iterations=3)
    i0 = jax.numpy.asarray(np.random.default_rng(0).uniform(
        0, 255, (2, 32, 48)).astype(np.float32))
    rows = bench_levels.level_times(i0, i0, params)
    shapes = pyramid_shapes(32, 48, params.nscales, params.scale_step)
    assert [r["stage"] for r in rows] == [
        "pyramid (both frames)", "level 2", "upscale 2->1", "level 1",
        "upscale 1->0", "level 0"]
    assert [r["shape"] for r in rows if "shape" in r] == [
        list(s) for s in shapes[::-1]]
    assert all(r["ms"] >= 0 for r in rows)
