"""Random point-match sampling from solved flow/map fields.

Reimplements the reference's ``random_points`` (src/optflow.cpp:522-572):
sample up to ``npoints`` valid pixels uniformly at random, convert to
full-resolution coordinates, and emit Render-schema match lists. The two
coordinate semantics are preserved:

- features branch: the flow arrays are *absolute warped maps*, so
  ``q = (map_value + q_roi_offset) * inv_scale``
- non-features branch: the flow arrays are *displacements*, so
  ``q = (pos + q_roi_offset + flow_value) * inv_scale``

``p = (pos + p_roi_offset) * inv_scale`` in both. All weights are 1. An
empty valid mask yields one dummy match (-1,-1)->(-1,-1) with weight 0 so
downstream consumers never see empty fields (src/optflow.cpp:560-569).
In debug mode sampling is deterministic (src/optflow.cpp:532-535).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from optflow.engine.rois import Roi


def random_points(
    flow_x: np.ndarray,
    flow_y: np.ndarray,
    mask: np.ndarray,
    roi_vec: Sequence[Roi],
    *,
    npoints: int = 25,
    inv_scale: float = 2.0,
    features: bool = False,
    debug: bool = False,
    point_matches: Dict | None = None,
) -> Dict:
    """Sample matches and append them to a per-pair accumulator dict with
    keys ``p``/``q`` (each [xs, ys]) and ``w``."""
    if point_matches is None or not point_matches:
        point_matches = {"p": [[], []], "q": [[], []], "w": []}

    ys, xs = np.nonzero(mask)
    n_valid = len(xs)
    roi_p, roi_q = roi_vec[0], roi_vec[1]

    if n_valid == 0:
        point_matches["p"][0].append(-1)
        point_matches["p"][1].append(-1)
        point_matches["q"][0].append(-1)
        point_matches["q"][1].append(-1)
        point_matches["w"].append(0)
        return point_matches

    rng = np.random.default_rng(0) if debug else np.random.default_rng()
    order = rng.permutation(n_valid)[: min(npoints, n_valid)]

    for idx in order:
        px, py = int(xs[idx]), int(ys[idx])
        fx = float(flow_x[py, px])
        fy = float(flow_y[py, px])
        point_matches["w"].append(1)
        point_matches["p"][0].append((px + roi_p.x) * inv_scale)
        point_matches["p"][1].append((py + roi_p.y) * inv_scale)
        if features:
            point_matches["q"][0].append((fx + roi_q.x) * inv_scale)
            point_matches["q"][1].append((fy + roi_q.y) * inv_scale)
        else:
            point_matches["q"][0].append((px + roi_q.x + fx) * inv_scale)
            point_matches["q"][1].append((py + roi_q.y + fy) * inv_scale)
    return point_matches


def move_pm(im_args: Dict, args: Dict) -> None:
    """Wrap one pair's accumulated matches into the Render match schema and
    append to the job-global list (ref: src/optflow.cpp:574-593)."""
    single_pair = {
        "pGroupId": im_args.get("pGroupId"),
        "pId": im_args.get("pId"),
        "qGroupId": im_args.get("qGroupId"),
        "qId": im_args.get("qId"),
        "matches": im_args.get("point_matches", {"p": [[], []], "q": [[], []], "w": []}),
    }
    args.setdefault("point_matches", []).append(single_pair)
    im_args["point_matches"] = {}
