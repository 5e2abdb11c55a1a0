#!/usr/bin/env python
"""Job-level benchmark: the PRODUCT, not just the kernel.

Runs a production-shape job through engine.run_job_batched on the GPU:
strip-ROI pairs (top/bottom, the production output
mode of gen_cross_file_list defaults), ``random_points`` output, PNG
decode from disk through the prefetching native loader, journal on, and
a mock render-ws HTTP sink (full JSON serialization, no network — this
environment has no egress). The reference's unit of work is the
5,000-pair job file (support_scripts/gen_cross_file_list.py:118-119;
src/optflow.cpp:87-171) — this is that loop, timed end to end.

Prints ONE JSON line: job-level MP-pairs/s (megapixels of solved ROI
area per second) plus the StageTimer decode/solve/postprocess/sink
breakdown, and a correctness gate on the emitted point matches against
the known synthetic inter-section shift. Exits non-zero unless JAX's
default backend is a GPU, and when the gate fails.

Usage: python bench_job.py [--pairs N]
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

SRC_H, SRC_W = 1024, 2048  # on-disk PNG sections
SCALE = 0.5                # production default (src/optflow.cpp:92)
STRIP = 256                # top/bottom ROI rows at working resolution
# per-z-step true shift of the synthetic stack, in FULL-RES pixels
DX_STEP, DY_STEP = 2.2, -1.2
MAX_DZ = 3                 # pair graph z-distance (docs/example_gen_cross:1)
CACHE_TAG = "v1"


def _stack_dir(n_frames: int) -> pathlib.Path:
    root = os.environ.get("OPTFLOW_BENCH_STACK") or os.path.join(
        tempfile.gettempdir(), "optflow_bench_stack"
    )
    return pathlib.Path(root) / f"{CACHE_TAG}_{n_frames}_{SRC_H}x{SRC_W}"


def gen_stack(n_frames: int, d: pathlib.Path = None) -> pathlib.Path:
    """Synthesize a FIB-SEM-like section stack as 8-bit grayscale PNGs.

    Section z is a crop of one large base texture at offset
    z * (DY_STEP, DX_STEP) plus small per-section noise, so the true
    flow between sections (z, z+dz) is the constant dz * (DX, DY)
    (up to the noise), letting the bench gate the emitted point
    matches. Cached on disk across runs (``d`` defaults to a directory
    under the temp dir, keyed by the geometry)."""
    from optflow.core.imgio import write_png

    d = d or _stack_dir(n_frames)
    done = d / "DONE"
    if done.exists():
        return d
    d.mkdir(parents=True, exist_ok=True)
    import scipy.ndimage as ndi

    rng = np.random.default_rng(7)
    pad_h = int(abs(DY_STEP) * n_frames) + 8
    pad_w = int(abs(DX_STEP) * n_frames) + 8
    big_h, big_w = SRC_H + pad_h, SRC_W + pad_w
    base = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 4.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 36.0)
    tex = base * 2.0 + lowf * 4.0
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    tex = 20.0 + 215.0 * tex
    ys = np.arange(SRC_H)
    xs = np.arange(SRC_W)
    for z in range(n_frames):
        # backward-warp crop so fractional per-z offsets stay exact
        oy = pad_h / 2 - DY_STEP * (z - n_frames / 2)
        ox = pad_w / 2 - DX_STEP * (z - n_frames / 2)
        gy, gx = np.meshgrid(ys + oy, xs + ox, indexing="ij")
        sec = ndi.map_coordinates(tex, [gy, gx], order=3, mode="nearest")
        sec = sec + rng.normal(0.0, 1.5, sec.shape)  # per-section noise
        arr = np.clip(sec, 0, 255).astype(np.uint8)
        write_png(str(d / f"sec_{z:04d}.png"), arr)
    done.write_text("ok")
    return d


def build_job(stack: pathlib.Path, n_frames: int, n_pairs: int,
              journal: str, tag: str) -> dict:
    """Reference-schema job dict: chained pairs at z-distance <= MAX_DZ
    (the production pair graph), strip ROIs, random_points output."""
    images = []
    for z in range(n_frames):
        for dz in range(1, MAX_DZ + 1):
            if z + dz >= n_frames or len(images) >= n_pairs:
                continue
            images.append({
                "p": str(stack / f"sec_{z:04d}.png"),
                "q": str(stack / f"sec_{z + dz:04d}.png"),
                "pId": f"tile_{z}", "qId": f"tile_{z + dz}",
                "pGroupId": f"{z}.0", "qGroupId": f"{z + dz}.0",
                "output_name": f"{tag}_{z}_{z + dz}",
                "dz": dz,  # bench-only: carried through for the gate
            })
    return {
        "style": 1,
        "scale": SCALE,
        "output_type": "random_points",
        "rois": {"top": STRIP, "bottom": STRIP},
        "npoints": 25,
        "batch_size": 100,
        "pair_batch": 16,
        "journal": journal,
        "images": images[:n_pairs],
    }


class MockRenderSink:
    """render-ws stand-in: full JSON serialization of every PUT batch
    (the host cost the real sink pays), no network."""

    def __init__(self):
        self.puts = 0
        self.bytes = 0
        self.match_sets = []

    def put(self, matches):
        payload = json.dumps(matches).encode("utf-8")
        self.puts += 1
        self.bytes += len(payload)
        self.match_sets.extend(matches)
        return True


def gate_matches(match_sets, job: dict) -> dict:
    """End-to-end correctness: emitted q - p displacements (Render-schema
    match dicts, as a sink receives them) must match the known synthetic
    shift dz * (DX_STEP, DY_STEP) in full-res px."""
    by_name = {}
    for im in job["images"]:
        by_name[(im["pId"], im["qId"])] = im["dz"]
    errs = []
    for ms in match_sets:
        dz = by_name.get((ms["pId"], ms["qId"]))
        m = ms["matches"]
        if dz is None or not m["w"]:
            continue
        p = np.asarray(m["p"], np.float64)  # (2, k)
        q = np.asarray(m["q"], np.float64)
        w = np.asarray(m["w"])
        if p.shape[1] == 0 or w.max() == 0:
            continue
        d = q - p
        errs.append(np.hypot(d[0] - dz * DX_STEP, d[1] - dz * DY_STEP))
    if not errs:
        return {"match_err_px": None, "match_ok": False}
    err = float(np.mean(np.concatenate(errs)))
    # full-res px; the solve itself is gated at 0.5 px at scale 0.5
    return {"match_err_px": err, "match_ok": err <= 1.0}


def run(job: dict, sink: MockRenderSink) -> dict:
    from optflow.engine.batch_runner import run_job_batched

    t0 = time.perf_counter()
    stats = run_job_batched(job, sink=sink)
    stats["wall"] = time.perf_counter() - t0
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=512)
    args = ap.parse_args()

    from bench import device_record, require_gpu
    from optflow.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    dev = require_gpu()

    n_pairs = args.pairs
    n_frames = n_pairs // MAX_DZ + MAX_DZ + 1
    stack = gen_stack(n_frames)

    tmp = tempfile.mkdtemp(prefix="optflow_bench_job_")
    # warmup job: compile every program shape (levels, prealign buckets)
    warm = build_job(stack, n_frames, 32, f"{tmp}/warm.jsonl", "warm")
    run(warm, MockRenderSink())

    job = build_job(stack, n_frames, n_pairs, f"{tmp}/job.jsonl", "job")
    sink = MockRenderSink()
    stats = run(job, sink)

    mp_per_pair = 2 * STRIP * (SRC_W * SCALE) / 1e6
    wall = stats["wall"]
    pairs = stats["pairs"]
    mp_s = pairs * mp_per_pair / wall
    gate = gate_matches(sink.match_sets, job)

    result = {
        "metric": "job-level MP-pairs/s (run_job_batched: decode->solve->"
                  "sample->sink, strip ROIs, random_points)",
        "value": mp_s,
        "unit": "MP-pairs/s",
        "vs_baseline": mp_s,
        "device": device_record(dev),
        "pairs": pairs,
        "pairs_per_s": pairs / wall,
        "wall_s": wall,
        "mp_per_pair": mp_per_pair,
        "stage_breakdown_s": {
            k: v for k, v in stats["timing"].items() if k.endswith("_s")
        },
        "batched": stats["batched"],
        "sequential": stats["sequential"],
        "uploads": stats["uploads"],
        "matches": stats["matches"],
        "sink_bytes": sink.bytes,
        **gate,
    }
    print(json.dumps(result))
    if not gate["match_ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
