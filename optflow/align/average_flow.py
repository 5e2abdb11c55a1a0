"""Average-flow temporal stack aligner — the reference's dormant style 2.

The reference carries this mode as commented-out code it intended to revive
(src/optflow.cpp:67-70,180-226,263-300; prototypes kept in
src/optflow.h:17-19): align each section against a Gaussian-weighted
average of its +/-3 neighbors, then resample the section onto the average's
frame. Reimplemented here with JSON job support (the missing piece the
comment asks for):

- neighbor weights e^{-x^2/4} for |dz| in {1,2,3}, renormalized to sum to 1
  over the 6 neighbors (src/optflow.cpp:189-191)
- TV-L1 from the section to the blurred target at ``scale``, flow rescaled
  by 1/scale and upsampled to full resolution (src/optflow.cpp:273-276)
- inverse-map resampling: map(x) = x - flow(x), border-padded, bilinear
  remap, written as <index>.tiff (src/optflow.cpp:278-299)

Job keys (style 2): ``file_list`` (ordered section paths) or ``images``
with ``p`` entries, ``output_dir``, ``scale`` (default 0.5), ``border``
(default 0), plus the standard TV-L1 keys.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp

from optflow.core.config import JobConfig, TVL1Params
from optflow.core.imgio import read_gray, resize_scale, write_float_tiff
from optflow.ops.pyramid import resize_bilinear
from optflow.ops.tvl1 import tvl1_flow
from optflow.ops.warp import bilinear_sample

# e^{-x^2/4} at |dz| = 3, 2, 1, 1, 2, 3 — renormalized so the six weights
# sum to 1 (ref: src/optflow.cpp:189-191).
_RAW = [math.exp(-9.0 / 4.0), math.exp(-1.0), math.exp(-1.0 / 4.0)]
_NORM = 0.5 / sum(_RAW)
WEIGHTS = [w * _NORM for w in (_RAW + _RAW[::-1])]


def _remap_inverse(frame: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    """Resample frame at map(x) = x - flow(x) (ref: src/optflow.cpp:286-298)."""
    h, w = frame.shape
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    return bilinear_sample(frame, xs - flow[..., 0], ys - flow[..., 1])


def average_flow_job(args: Dict) -> List[str]:
    """Run the style-2 aligner over a job dict; returns written paths."""
    cfg = JobConfig(args)
    if "file_list" in args:
        paths = [str(p) for p in args["file_list"]]
    else:
        paths = [str(im["p"]) for im in cfg.images]
    if len(paths) < 7:
        raise ValueError(
            f"average_flow needs at least 7 sections, got {len(paths)}"
        )
    out_dir = str(args.get("output_dir", "."))
    scale = float(args.get("scale", 0.5))
    border = int(args.get("border", 0))
    params = TVL1Params.from_config({}, args)

    frames = [read_gray(p).astype(np.float32) for p in paths[:7]]
    written: List[str] = []

    @jax.jit
    def solve_one(frame, blur):
        h, w = frame.shape
        sh = (int(round(h * scale)), int(round(w * scale)))
        f_s = resize_bilinear(frame, sh)
        b_s = resize_bilinear(blur, sh)
        flow_s = tvl1_flow(f_s, b_s, params) * (1.0 / scale)
        flow = jax.image.resize(flow_s, (h, w, 2), "linear", antialias=False)
        if border:
            frame = jnp.pad(frame, border)
            flow = jnp.pad(flow, ((border, border), (border, border), (0, 0)))
        return _remap_inverse(frame, flow)

    for i in range(3, len(paths) - 3):
        # frames deque holds sections [i-3 .. i+3]
        blur = sum(
            w * f
            for w, f in zip(WEIGHTS, frames[:3] + frames[4:])
        )
        aligned = np.asarray(solve_one(jnp.asarray(frames[3]), jnp.asarray(blur)))
        out_path = f"{out_dir}/{i}.tiff"
        write_float_tiff(out_path, aligned)
        written.append(out_path)
        print(f"N: {i} {paths[i]}")

        if i + 4 < len(paths):
            frames.pop(0)
            frames.append(read_gray(paths[i + 4]).astype(np.float32))
    return written
