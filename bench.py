#!/usr/bin/env python
"""Benchmark: TV-L1 throughput + EPE on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Headline metric: megapixel image-pairs/s per card for coarse-to-fine TV-L1
at the reference's default parameters (tau=.25, lambda=.05, theta=.3,
nscales=10, warps=5, iterations=300, eps=.01, scaleStep=.8 — the exact
defaults of src/optflow.cpp:503-512). The reference publishes no numbers
(BASELINE.md), so vs_baseline is reported against a 1.0 MP-pairs/s nominal
target; the EPE gate (<=0.5 px) is checked alongside, against the
synthetic truth and against the committed IPOL-oracle flow.

The script exits non-zero unless JAX's default backend is a GPU.

Usage: python bench.py
"""

import json
import os
import sys
import time

import numpy as np

H, W = 256, 1024  # production-representative strip geometry (SURVEY.md §6)
# Batch size: production jobs stream thousands of pairs (5000/job file,
# gen_cross_file_list.py:118-119), so a 16-pair device batch is the
# realistic granularity.
BATCH = 16
DX, DY = 2.0, -1.25
REPS = 5
ORACLE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tests", "fixtures", "golden_oracle_256x1024.npz",
)


def require_gpu():
    """The first JAX device, which must be a GPU. JAX falls back to the
    CPU quietly when its CUDA plugin fails to load; a measurement on that
    fallback is not a GPU number, so stop instead."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def device_record(dev) -> dict:
    import jax

    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def make_pair(h, w, dx, dy, seed=0):
    """Synthetic FIB-SEM-like pair with known ground-truth flow (dx, dy)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((h, w))
    tex = ndi.gaussian_filter(base, 2.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((h, w)), 18.0)
    im = tex * 2.0 + lowf * 4.0
    im = (im - im.min()) / (np.ptp(im) + 1e-9)
    im0 = (20.0 + 215.0 * im).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    im1 = ndi.map_coordinates(
        im0, [ys - dy, xs - dx], order=3, mode="nearest"
    ).astype(np.float32)
    return im0, im1


def oracle_flow():
    """Committed golden flow for pair seed=0 at the production shape,
    solved once by the independent IPOL oracle (tests/reference_tvl1.py)
    at the reference-default parameters."""
    d = np.load(ORACLE_PATH)
    if not (float(d["dx"]) == DX and float(d["dy"]) == DY
            and int(d["seed"]) == 0):
        raise SystemExit(f"oracle fixture {ORACLE_PATH} does not match "
                         f"the bench pair (dx={DX}, dy={DY}, seed=0)")
    return d["flow"]


def epe(flow, ref, margin=16):
    """Mean end-point error over the interior; ``ref`` is a flow field of
    the same (H, W, 2) shape or a constant (dx, dy)."""
    inner = np.asarray(flow, np.float64)[..., margin:-margin, margin:-margin, :]
    ref = np.asarray(ref, np.float64)
    if ref.ndim == 3:
        ref = ref[margin:-margin, margin:-margin]
    return float(np.sqrt(((inner - ref) ** 2).sum(-1)).mean())


def main():
    import jax

    from optflow.core.config import TVL1Params
    from optflow.ops.tvl1 import tvl1_flow_batched
    from optflow.utils.cache import enable_persistent_cache
    from optflow.utils.metrics import profiler_trace

    enable_persistent_cache()
    dev = require_gpu()
    params = TVL1Params()  # reference defaults

    pairs = [make_pair(H, W, DX, DY, seed=i) for i in range(BATCH)]
    i0 = jax.device_put(np.stack([p[0] for p in pairs]))
    i1 = jax.device_put(np.stack([p[1] for p in pairs]))

    t0 = time.perf_counter()
    flow = np.asarray(tvl1_flow_batched(i0, i1, params))
    compile_and_first_s = time.perf_counter() - t0
    epe_truth = epe(flow, (DX, DY))
    epe_oracle = epe(flow[0], oracle_flow())

    # latency: one batch at a time, each waited for
    times = []
    with profiler_trace(os.environ.get("OPTFLOW_PROFILE_DIR")):
        for _ in range(REPS):
            t0 = time.perf_counter()
            tvl1_flow_batched(i0, i1, params).block_until_ready()
            times.append(time.perf_counter() - t0)
    # steady state: REPS batches enqueued back to back, one wait
    t0 = time.perf_counter()
    outs = [tvl1_flow_batched(i0, i1, params) for _ in range(REPS)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / REPS
    mp_pairs_per_s = BATCH * (H * W / 1e6) / dt

    ok = epe_truth <= 0.5 and epe_oracle <= 0.5
    print(json.dumps({
        "metric": "megapixel image-pairs/s per card (TV-L1, ref defaults)",
        "value": mp_pairs_per_s,
        "unit": "MP-pairs/s",
        "vs_baseline": mp_pairs_per_s / 1.0,
        "epe_px": epe_truth,
        "epe_vs_oracle_px": epe_oracle,
        "epe_target_px": 0.5,
        "epe_ok": ok,
        "device": device_record(dev),
        "shape": [BATCH, H, W],
        "seconds_per_batch": dt,
        "latency_s_per_batch": float(np.median(times)),
        "compile_and_first_batch_s": compile_and_first_s,
    }))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
