#!/usr/bin/env python
"""Per-level economics of the plain XLA TV-L1 solver on the GPU.

Measures, at the headline shape (16x256x1024, reference defaults):

- levels: device time of each pyramid level's batched solve, run as the
  coarse-to-fine chain runs it (each level its own jitted program, host
  clock around ``block_until_ready``), plus the pyramid build and the
  upscaling between levels;
- iteration: time per primal-dual iteration at the finest and the
  coarsest level, from two fixed-count solves (50 and 250 iterations, one
  warp) on the ``fori_loop`` path (epsilon 0) and on the ``while_loop``
  path (an epsilon that never fires); bytes per pixel-iteration from the
  compiled HLO of one batched iteration, and the iteration's share of the
  HBM roofline at the algorithm's least traffic;
- host round trips: a profiler trace of the ``while_loop`` solve at the
  coarsest level, reduced to device-to-host copies and kernel launches
  per iteration;
- the whole batched solve: a profiler trace reduced to the device's busy
  and idle share and its top kernels.

Prints one JSON line, and with ``--out`` also writes it, indented, to
PATH. GPU only.

Usage: python bench_levels.py [--out PATH]
"""

import argparse
import glob
import json
import os
import tempfile
import time

import numpy as np

# NVIDIA H100 SXM data sheet (dense, full 700 W power limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}
# Least HBM traffic of one primal-dual iteration (gamma = 0) per pixel:
# u1, u2 and the four dual fields read and written, and the warped
# gradients, |grad|^2 and rho_c read; 16 float32 values.
MIN_BYTES_PER_PX_ITER = 4 * (2 * 6 + 4)


def _timed(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def level_times(i0, i1, params):
    """Per-level device time of the coarse-to-fine chain."""
    import jax
    import jax.numpy as jnp

    from optflow.ops.pyramid import build_pyramid, pyramid_shapes, upscale_flow
    from optflow.ops.tvl1 import tvl1_flow_level

    n, h, w = i0.shape
    shapes = pyramid_shapes(h, w, params.nscales, params.scale_step)
    pyr = jax.jit(jax.vmap(lambda a: build_pyramid(a, shapes)))
    rows = [{"stage": "pyramid (both frames)",
             "ms": 2e3 * _timed(pyr, i0)}]
    p0, p1 = pyr(i0), pyr(i1)
    solve = jax.jit(jax.vmap(
        lambda a, b, u, v: tvl1_flow_level(a, b, u, v, params)[:2]))
    u1 = u2 = jnp.zeros((n,) + shapes[-1], jnp.float32)
    for s in range(len(shapes) - 1, -1, -1):
        args = (p0[s], p1[s], u1, u2)
        rows.append({"stage": f"level {s}", "shape": list(shapes[s]),
                     "ms": 1e3 * _timed(solve, *args)})
        u1, u2 = solve(*args)
        if s > 0:
            up = jax.jit(jax.vmap(lambda a, b, sh=shapes[s - 1]: upscale_flow(
                a, b, sh, params.scale_step)))
            rows.append({"stage": f"upscale {s}->{s - 1}",
                         "ms": 1e3 * _timed(up, u1, u2)})
            u1, u2 = up(u1, u2)
    return rows


def iteration_cost(i0, i1, params, shape):
    """Seconds per iteration on both loop paths at one level shape."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from optflow.ops.pyramid import resize_bilinear
    from optflow.ops.tvl1 import tvl1_flow_level

    a = jax.vmap(lambda x: resize_bilinear(x, shape))(i0)
    b = jax.vmap(lambda x: resize_bilinear(x, shape))(i1)
    u = jnp.zeros(a.shape, jnp.float32)
    out = {}
    for path, eps in (("fori", 0.0), ("while", 1e-30)):
        t = {}
        for iters in (50, 250):
            p = dataclasses.replace(params, warps=1, iterations=iters,
                                    epsilon=eps)
            f = jax.jit(jax.vmap(
                lambda x, y, s, v, p=p: tvl1_flow_level(x, y, s, v, p)[0]))
            t[iters] = _timed(f, a, b, u, u)
        out[path] = (t[250] - t[50]) / 200
    return out


def iteration_bytes(n, shape):
    """HBM bytes per pixel-iteration XLA's cost model assigns to one
    batched primal-dual iteration, from the compiled HLO."""
    import jax
    import jax.numpy as jnp

    from optflow.ops.tvl1 import _LevelState, _iteration

    def step(st, wx, wy, g, r):
        return _iteration(st, wx, wy, g, r, 0.015, 0.3, 0.25 / 0.3, 0.0)

    x = jax.ShapeDtypeStruct((n,) + tuple(shape), jnp.float32)
    st = _LevelState(*([x] * 9))
    compiled = jax.jit(jax.vmap(step)).lower(st, x, x, x, x).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    px = n * shape[0] * shape[1]
    return {"hlo_bytes_per_px_iter": float(cost["bytes accessed"]) / px,
            "hlo_flops_per_px_iter": float(cost.get("flops", 0.0)) / px}


def busy_ns(spans):
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def trace_summary(fn, args, trace_dir):
    """Profile one call of ``fn`` (already compiled) and reduce the trace
    to what each GPU plane ran: event and memcpy counts, the window from
    first to last event, the busy union and the top events by time."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(fn(*args))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    planes = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        names = {}
        spans = []
        for line in plane.lines:
            for ev in line.events:
                d = names.setdefault(ev.name, [0, 0.0])
                d[0] += 1
                d[1] += ev.duration_ns / 1e3
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        if not spans:
            continue
        busy = busy_ns(spans)
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
        planes[plane.name] = {
            "events": sum(v[0] for v in names.values()),
            "memcpy_events": sum(v[0] for k, v in names.items()
                                 if "memcpy" in k.lower()),
            "window_us": window / 1e3,
            "busy_us": busy / 1e3,
            "idle_share": 1.0 - busy / window if window else None,
            "top": [{"name": k[:80], "count": v[0], "us": v[1]}
                    for k, v in top],
        }
    return planes


def trace_while(i0, i1, params, shape, trace_dir, iters=100):
    """The while_loop path at one level shape: what the device and the
    host copy per iteration."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from optflow.ops.pyramid import resize_bilinear
    from optflow.ops.tvl1 import tvl1_flow_level

    a = jax.vmap(lambda x: resize_bilinear(x, shape))(i0)
    b = jax.vmap(lambda x: resize_bilinear(x, shape))(i1)
    u = jnp.zeros(a.shape, jnp.float32)
    p = dataclasses.replace(params, warps=1, iterations=iters, epsilon=1e-30)
    f = jax.jit(jax.vmap(
        lambda x, y, s, v: tvl1_flow_level(x, y, s, v, p)[0]))
    return {"iterations": iters,
            "planes": trace_summary(f, (a, b, u, u), trace_dir)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the record to this file")
    ns = ap.parse_args()

    import jax

    from bench import DX, DY, device_record, make_pair, require_gpu
    from optflow.core.config import TVL1Params
    from optflow.ops.pyramid import pyramid_shapes
    from optflow.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    dev = require_gpu()
    from chip_smoke import card_info

    params = TVL1Params()
    n, h, w = 16, 256, 1024
    pairs = [make_pair(h, w, DX, DY, seed=i) for i in range(n)]
    i0 = jax.device_put(np.stack([p[0] for p in pairs]))
    i1 = jax.device_put(np.stack([p[1] for p in pairs]))
    shapes = pyramid_shapes(h, w, params.nscales, params.scale_step)

    rec = {"device": device_record(dev), "card": card_info(),
           "shape": [n, h, w], "levels": level_times(i0, i1, params)}
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no peak rates for {dev.device_kind!r} in PEAKS")
    hbm = PEAKS[dev.device_kind]["hbm_bytes_per_s"]
    rec["iteration"] = {}
    for name, shape in (("finest", shapes[0]), ("coarsest", shapes[-1])):
        sec = iteration_cost(i0, i1, params, shape)
        floor = MIN_BYTES_PER_PX_ITER * n * shape[0] * shape[1] / hbm
        rec["iteration"][name] = {
            "shape": list(shape), "s_per_iter": sec,
            **iteration_bytes(n, shape),
            "min_bytes_per_px_iter": MIN_BYTES_PER_PX_ITER,
            "hbm_floor_s_per_iter": floor,
            "hbm_roofline_share": {k: floor / v for k, v in sec.items()},
        }
    with tempfile.TemporaryDirectory() as td:
        rec["while_trace_coarsest"] = trace_while(
            i0, i1, params, shapes[-1], td)
    from optflow.ops.tvl1 import tvl1_flow_batched

    with tempfile.TemporaryDirectory() as td:
        rec["solve_trace"] = trace_summary(
            lambda a, b: tvl1_flow_batched(a, b, params), (i0, i1), td)
    if ns.out:
        os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
        with open(ns.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
