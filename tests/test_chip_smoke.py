"""chip_smoke.py's CPU-checkable contract: it refuses any backend but a
GPU, and in a directory without the repository, with a non-zero exit and
no result line; the result line it prints on success is well formed."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _result_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "ok" in rec:
            out.append(rec)
    return out


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_refuses_cpu_backend(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _result_lines(r.stdout) == []


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert _result_lines(r.stdout) == []


def test_result_line_is_well_formed():
    sys.path.insert(0, REPO)
    import chip_smoke

    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line(dev, 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
