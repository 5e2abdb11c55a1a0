#!/usr/bin/env python
"""On-card smoke test: the TV-L1 job path on one GPU, end to end.

Phases (each one raises on failure, so the script exits non-zero and
prints no result line):

1. device — JAX's default backend must be a GPU (JAX falls back to the
   CPU quietly when its CUDA plugin fails to load); prints the card's
   name and power limit, the device kind, the JAX version and the image
   loader in use.
2. solve — ``tvl1_flow_batched`` at 16x256x1024 with the reference
   defaults: EPE against the synthetic truth and pair 0's EPE against the
   committed IPOL-oracle flow, both <= 0.5 px; the GPU solve against the
   same program on the CPU at 96x128 with a fixed iteration count.
3. job — ``optflow.cli.main.main`` in-process on generated 8-bit PNG
   sections at bench_job.py's geometry: a ``random_points`` job of 64
   pairs over dz <= 3 into a jsonl sink (mean match error <= 1.0 px
   against the known shift), 4 pairs with ``output_type: map`` read back
   from their TIFFs, and 4 full-frame pairs with SURF pre-alignment on a
   stack related by a known affine.

``--four-cards`` runs only the four-card path instead: the job with
``output_type: flow`` on the default mesh over all cards against a
one-card mesh, the PairScheduler over all cards against a one-card
solve, and ``tiled_tvl1_flow`` over 4 row blocks of a 1024x1024 section
against the monolithic one-card solve.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import glob
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench
import bench_job

# GPU-vs-CPU comparison at 96x128, epsilon 0, fixed iteration count: the
# two backends round differently (FMA contraction, sqrt/division), and
# the soft-threshold step is piecewise, so a pixel on a branch boundary
# can take the other branch and carry the difference into later
# iterations. Fixed iterations keep exit-count differences out. An H100
# measured 5.5e-5 px max and 3.8e-7 px mean; the limits leave 18x and
# 26x of headroom and stay far below the 0.5 px EPE budget.
CMP_MAX_PX = 1e-3
CMP_MEAN_PX = 1e-5
# The four-card runs compute the same per-pair programs on other cards
# and other batch splits; only rounding may differ.
MULTI_MAX_PX = 1e-3
# Tiled solve: each row block solves its own halo window, so coarse
# levels see less context than the monolithic solve; gated at the EPE
# budget.
TILED_MAX_PX = 0.5
# Known affine between consecutive sections of the features stack,
# full-res px: a 0.3 degree rotation about the centre, 0.2% zoom, and a
# shift. Well inside the reference's 20% zoom gate.
FEAT_ROT_DEG, FEAT_ZOOM, FEAT_SHIFT = 0.3, 1.002, (6.0, -4.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    log(f"  ok: {what}")


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def result_line(dev, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }})


def image_loader() -> str:
    """The decoder a job's frames go through: the native threaded loader
    when it builds, else the Python decoder imgio picks."""
    from optflow import native
    from optflow.core.imgio import python_decoder

    return "native" if native.available() else python_decoder()


# ---------------------------------------------------------------- phases


def phase_device():
    import jax

    log("== phase device")
    dev = bench.require_gpu()
    card = card_info()
    log("  card (name, power limit), as nvidia-smi gives them:")
    log(card)
    log(f"  jax {jax.__version__}, device_kind {dev.device_kind!r}, "
        f"{len(jax.devices())} device(s)")
    log(f"  image loader: {image_loader()}")
    return dev, card


def phase_solve(card: str, batch=16, h=256, w=1024, cmp_hw=(96, 128)):
    import jax

    from optflow.core.config import TVL1Params
    from optflow.ops.tvl1 import tvl1_flow_batched

    log(f"== phase solve ({batch}x{h}x{w}, reference defaults)")
    params = TVL1Params()
    pairs = [bench.make_pair(h, w, bench.DX, bench.DY, seed=i)
             for i in range(batch)]
    i0 = jax.device_put(np.stack([p[0] for p in pairs]))
    i1 = jax.device_put(np.stack([p[1] for p in pairs]))
    t0 = time.perf_counter()
    flow = np.asarray(tvl1_flow_batched(i0, i1, params))
    log(f"  compile + first batch: {time.perf_counter() - t0:.3f} s")
    check(flow.shape == (batch, h, w, 2) and np.isfinite(flow).all(),
          f"flow shape {flow.shape}, all finite")
    e = bench.epe(flow, (bench.DX, bench.DY))
    check(e <= 0.5, f"EPE vs synthetic truth {e:.4f} px <= 0.5")
    if (h, w) == (256, 1024):
        eo = bench.epe(flow[0], bench.oracle_flow())
        check(eo <= 0.5, f"pair-0 EPE vs IPOL oracle {eo:.4f} px <= 0.5")
    reps = 3
    t0 = time.perf_counter()
    jax.block_until_ready(
        [tvl1_flow_batched(i0, i1, params) for _ in range(reps)])
    dt = (time.perf_counter() - t0) / reps
    log(f"  wall per batch: {dt:.4f} s "
        f"({batch * h * w / 1e6 / dt:.3f} MP-pairs/s) on {card}")

    ch, cw = cmp_hw
    p_fixed = TVL1Params(epsilon=0.0, iterations=50)
    cmp_pairs = [bench.make_pair(ch, cw, bench.DX, bench.DY, seed=i)
                 for i in range(2)]
    a = np.stack([p[0] for p in cmp_pairs])
    b = np.stack([p[1] for p in cmp_pairs])
    cpu = jax.devices("cpu")[0]
    f_dev = np.asarray(tvl1_flow_batched(a, b, p_fixed))
    f_cpu = np.asarray(tvl1_flow_batched(
        jax.device_put(a, cpu), jax.device_put(b, cpu), p_fixed))
    d = np.abs(f_dev - f_cpu)
    check(d.max() <= CMP_MAX_PX and d.mean() <= CMP_MEAN_PX,
          f"{jax.devices()[0].platform} vs cpu at {ch}x{cw}, eps 0, "
          f"50 iterations: max |diff| {d.max():.3e} px <= {CMP_MAX_PX}, "
          f"mean {d.mean():.3e} px <= {CMP_MEAN_PX}")


def _affine_stack(d: pathlib.Path, n_frames: int, src_h: int, src_w: int):
    """Sections related by one known full-res affine T between neighbours:
    section k+1 at z equals section k at T(z). Returns T as 3x3."""
    import scipy.ndimage as ndi

    from optflow.core.imgio import write_png

    d.mkdir(parents=True, exist_ok=True)
    th = np.deg2rad(FEAT_ROT_DEG)
    cx, cy = (src_w - 1) / 2.0, (src_h - 1) / 2.0
    lin = FEAT_ZOOM * np.array([[np.cos(th), -np.sin(th)],
                                [np.sin(th), np.cos(th)]])
    t = np.array([cx, cy]) - lin @ np.array([cx, cy]) + np.array(FEAT_SHIFT)
    T = np.eye(3)
    T[:2, :2], T[:2, 2] = lin, t
    rng = np.random.default_rng(11)
    pad = 64
    big_h, big_w = src_h + 2 * pad, src_w + 2 * pad
    base = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 4.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((big_h, big_w)), 36.0)
    tex = base * 2.0 + lowf * 4.0
    tex = 20.0 + 215.0 * (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    ys, xs = np.mgrid[0:src_h, 0:src_w].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    Tk = np.eye(3)
    for k in range(n_frames):
        q = Tk @ pts  # section k at z = section 0 at T^k(z)
        sec = ndi.map_coordinates(
            tex, [q[1] + pad, q[0] + pad], order=3, mode="nearest"
        ).reshape(src_h, src_w)
        sec = sec + rng.normal(0.0, 1.5, sec.shape)
        write_png(str(d / f"aff_{k:04d}.png"),
                  np.clip(sec, 0, 255).astype(np.uint8))
        Tk = T @ Tk
    return T


def _run_cli(job: dict, path: str) -> None:
    from optflow.cli.main import main as cli_main

    with open(path, "w") as f:
        json.dump(job, f)
    rc = cli_main([path])
    check(rc == 0, f"optflow CLI exit code {rc} for {os.path.basename(path)}")


def phase_job(work: pathlib.Path, n_pairs=64):
    from optflow.core.imgio import read_float_tiff

    scale = bench_job.SCALE
    log(f"== phase job ({bench_job.SRC_H}x{bench_job.SRC_W} PNG sections, "
        f"scale {scale}, strips of {bench_job.STRIP} rows)")
    n_frames = n_pairs // bench_job.MAX_DZ + bench_job.MAX_DZ + 1
    t0 = time.perf_counter()
    stack = bench_job.gen_stack(n_frames, work / "stack")
    log(f"  generated {n_frames} sections in {time.perf_counter() - t0:.1f} s")

    # random_points into a jsonl sink
    matches = str(work / "matches.jsonl")
    job = bench_job.build_job(stack, n_frames, n_pairs,
                              str(work / "journal.jsonl"), "rp")
    job.update(match_sink="jsonl", match_output=matches)
    check(len(job["images"]) == n_pairs,
          f"{n_pairs} pairs over dz <= {bench_job.MAX_DZ}")
    t0 = time.perf_counter()
    _run_cli(job, str(work / "rp.json"))
    log(f"  random_points job: {time.perf_counter() - t0:.1f} s "
        f"(compile included)")
    from optflow.sinks.store import JsonlMatchSink

    match_sets = JsonlMatchSink(matches).read_all()
    check(len(match_sets) == len(job["images"]),
          f"{len(match_sets)} match sets, one per pair")
    gate = bench_job.gate_matches(match_sets, job)
    check(gate["match_ok"],
          f"mean match error {gate['match_err_px']} full-res px <= 1.0")
    log(f"  image loader used by the job: {image_loader()}")

    # map output: absolute map = ROI-local identity + flow
    out_dir = work / "map_out"
    job = bench_job.build_job(stack, n_frames, 4, str(work / "jm.jsonl"),
                              "map")
    job.update(output_type="map", output_dir=str(out_dir))
    _run_cli(job, str(work / "map.json"))
    errs = []
    for im in job["images"]:
        dz = im["dz"]
        for roi in ("top", "bottom"):
            base = f"{out_dir}/{im['output_name']}_{scale:0.2f}_{roi}"
            mx, my = read_float_tiff(base + "_x.tiff"), read_float_tiff(
                base + "_y.tiff")
            h, w = mx.shape
            ys, xs = np.mgrid[0:h, 0:w]
            m = np.s_[16:-16, 16:-16]
            ex = mx[m] - xs[m] - dz * bench_job.DX_STEP * scale
            ey = my[m] - ys[m] - dz * bench_job.DY_STEP * scale
            errs.append(np.hypot(ex, ey).mean())
    check(max(errs) <= 0.5,
          f"map TIFFs of {len(job['images'])} pairs match the known shift: "
          f"worst mean error {max(errs):.4f} px <= 0.5")

    # full frame, no rois key, SURF pre-alignment (features: 2)
    src_h, src_w = bench_job.SRC_H, bench_job.SRC_W
    T = _affine_stack(work / "aff", 5, src_h, src_w)
    out_dir = work / "feat_out"
    images = [{
        "p": str(work / "aff" / f"aff_{k:04d}.png"),
        "q": str(work / "aff" / f"aff_{k + 1:04d}.png"),
        "output_name": f"feat_{k}",
    } for k in range(4)]
    job = {"style": 1, "scale": scale, "output_type": "map",
           "features": 2, "pair_batch": 16, "output_dir": str(out_dir),
           "images": images}
    t0 = time.perf_counter()
    _run_cli(job, str(work / "feat.json"))
    log(f"  features job: {time.perf_counter() - t0:.1f} s")
    # working-res pixel y sits at full-res 2y + 0.5 (half-pixel resize)
    S = np.array([[1 / scale, 0, 0.5 / scale - 0.5],
                  [0, 1 / scale, 0.5 / scale - 0.5], [0, 0, 1]])
    t_inv = np.linalg.inv(S) @ np.linalg.inv(T) @ S  # frame0 px -> frame1 px
    errs = []
    for im in images:
        base = f"{out_dir}/{im['output_name']}_{scale:0.2f}"
        mx, my = read_float_tiff(base + "_x.tiff"), read_float_tiff(
            base + "_y.tiff")
        h, w = mx.shape
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        tx = t_inv[0, 0] * xs + t_inv[0, 1] * ys + t_inv[0, 2]
        ty = t_inv[1, 0] * xs + t_inv[1, 1] * ys + t_inv[1, 2]
        m = np.s_[32:-32, 32:-32]
        errs.append(np.hypot(mx[m] - tx[m], my[m] - ty[m]).mean())
    check(max(errs) <= 0.5,
          f"features map TIFFs of 4 full-frame pairs match the known affine: "
          f"worst mean error {max(errs):.4f} px <= 0.5")


def phase_four_cards(work: pathlib.Path, n_pairs=64, sched_hw=(256, 1024),
                     tiled_hw=(1024, 1024)):
    import jax

    from optflow.core.config import TVL1Params
    from optflow.core.imgio import read_float_tiff
    from optflow.dist.mesh import make_pair_mesh
    from optflow.dist.scheduler import PairScheduler
    from optflow.dist.tiled import tiled_tvl1_flow
    from optflow.engine.batch_runner import run_job_batched
    from optflow.engine.features_glue import default_aligner
    from optflow.ops.tvl1 import tvl1_flow, tvl1_flow_batched

    n = len(jax.devices())
    log(f"== phase four-cards ({n} devices)")
    check(n == 4, f"{n} devices visible, 4 required")
    one = [jax.devices()[0]]

    n_frames = n_pairs // bench_job.MAX_DZ + bench_job.MAX_DZ + 1
    stack = bench_job.gen_stack(n_frames, work / "stack")
    outs = {}
    for tag in ("mesh4", "mesh1"):
        job = bench_job.build_job(stack, n_frames, n_pairs,
                                  str(work / f"{tag}.jsonl"), tag)
        job.update(output_type="flow", output_dir=str(work / tag))
        t0 = time.perf_counter()
        if tag == "mesh4":
            _run_cli(job, str(work / f"{tag}.json"))  # default mesh
        else:
            run_job_batched(job, aligner=default_aligner,
                            mesh=make_pair_mesh(devices=one))
        log(f"  {tag} flow job: {time.perf_counter() - t0:.1f} s")
        outs[tag] = sorted(glob.glob(str(work / tag / "*.tiff")))
    check(len(outs["mesh4"]) == len(outs["mesh1"]) == 4 * n_pairs,
          f"{len(outs['mesh4'])} flow TIFFs from each mesh")
    worst = max(
        float(np.abs(read_float_tiff(a) - read_float_tiff(b)).max())
        for a, b in zip(outs["mesh4"], outs["mesh1"])
    )
    check(worst <= MULTI_MAX_PX,
          f"flow TIFFs, 4-card mesh vs 1-card mesh: max |diff| "
          f"{worst:.3e} px <= {MULTI_MAX_PX}")

    h, w = sched_hw
    params = TVL1Params()
    pairs = [bench.make_pair(h, w, bench.DX, bench.DY, seed=i)
             for i in range(4 * 4 + 2)]  # not a multiple of 4: padding
    t0 = time.perf_counter()
    flows = PairScheduler(make_pair_mesh(), params).solve_pairs(pairs)
    log(f"  PairScheduler over {n} cards, {len(pairs)} pairs: "
        f"{time.perf_counter() - t0:.1f} s (compile included)")
    ref = np.asarray(tvl1_flow_batched(
        jax.device_put(np.stack([p[0] for p in pairs]), one[0]),
        jax.device_put(np.stack([p[1] for p in pairs]), one[0]), params))
    worst = max(float(np.abs(f - r).max()) for f, r in zip(flows, ref))
    check(worst <= MULTI_MAX_PX,
          f"PairScheduler vs one-card batched solve: max |diff| "
          f"{worst:.3e} px <= {MULTI_MAX_PX}")

    th, tw = tiled_hw
    a, b = bench.make_pair(th, tw, bench.DX, bench.DY, seed=0)
    mono = np.asarray(jax.jit(lambda x, y: tvl1_flow(x, y, params))(
        jax.device_put(a, one[0]), jax.device_put(b, one[0])))
    mesh = make_pair_mesh(n_pairs_axis=1, n_rows_axis=4)
    t0 = time.perf_counter()
    tiled = np.asarray(tiled_tvl1_flow(a, b, params, mesh))
    log(f"  tiled solve over 4 row blocks: {time.perf_counter() - t0:.1f} s "
        f"(compile included)")
    d = np.abs(tiled - mono)[:, 8:-8]
    check(d.max() <= TILED_MAX_PX,
          f"tiled ({th}x{tw}, rows=4) vs monolithic one-card solve: max "
          f"|diff| {d.max():.4f} px <= {TILED_MAX_PX}, mean {d.mean():.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path")
    ns = ap.parse_args(argv)

    import jax

    from optflow.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    dev, card = phase_device()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if ns.four_cards:
            phase_four_cards(work)
        else:
            phase_solve(card)
            phase_job(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("card (name, power limit):")
    log(card)
    print(result_line(dev, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
