"""Per-pair solve pipeline: ROI loop, feature pre-alignment, TV-L1 solve,
map/flow composition, background masking, output emission.

Reimplements solve_rois / solve_wrapper (src/optflow.cpp:312-496) with the
composition quirks preserved:

- features branch: absolute map = flow + identity, then the ROI-local map
  images are resampled by the full-frame affine with cv::warpAffine
  semantics (src/optflow.cpp:429-432) — the reference's approximation, kept
  for output parity; output "flow" subtracts identity back, any other
  output keeps the absolute map (src/optflow.cpp:434-443)
- non-features "map" output adds the identity map (src/optflow.cpp:445-466)
- background zero-mask where (possibly warped) frame1 <= 1.0 intensity
  (src/optflow.cpp:467-473)
- random_points valid mask = union of frame0 > 1 and frame1 > 1
  (src/optflow.cpp:486-493)
- custom_diff ROIs: different rects per frame, features ignored with a
  warning (src/optflow.cpp:351-363)
- the ``default`` ROI or a frame-size mismatch force feature pre-alignment
  even when not requested (src/optflow.cpp:366-377)

Documented deviations from the reference (SURVEY.md §5 quirks):
- alignment is computed once per pair and the warped frame reused across
  ROIs; the reference re-runs find_alignment on the already-warped frame
  for every subsequent ROI, compounding interpolation blur
- the identity map is built on-device with iota, not a host double loop
  (src/optflow.cpp:417-426)
- custom_diff always sees the unwarped frame1 even if an earlier ROI
  triggered feature warping
"""

from __future__ import annotations

import functools
import sys
from typing import Callable, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optflow.core.config import TVL1Params, cfg_get, resolve_features
from optflow.core.imgio import write_float_tiff
from optflow.engine.rois import Roi
from optflow.engine.sampler import random_points
from optflow.ops.tvl1 import tvl1_flow
from optflow.ops.warp import affine_warp

IDENTITY_AFFINE = np.array([[1.0, 0, 0], [0, 1.0, 0]], dtype=np.float32)

# aligner(frame1, frame0, im_args, args) -> 2x3 affine mapping frame1
# coords into frame0 space (the find_alignment contract,
# src/features.cpp:46-167 called at src/optflow.cpp:373).
Aligner = Callable[[np.ndarray, np.ndarray, Mapping, Mapping], np.ndarray]


@functools.lru_cache(maxsize=256)
def _roi_solver(h: int, w: int, params: TVL1Params, mode: str):
    """Per-ROI device pipeline, cached by static shape/params/mode: the
    solve and the post-processing are one jitted program.

    mode: "displacement" | "map" | "features_map" | "features_flow".
    Returns (out_x, out_y, valid_union_mask).
    """

    def post(flow, i0, i1, affine):
        fx = flow[..., 0]
        fy = flow[..., 1]
        if mode != "displacement":
            mx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
            my = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        if mode.startswith("features"):
            ax = fx + mx
            ay = fy + my
            nx = affine_warp(ax, affine)
            ny = affine_warp(ay, affine)
            if mode == "features_flow":
                fx, fy = nx - mx, ny - my
            else:
                fx, fy = nx, ny
        elif mode == "map":
            fx, fy = fx + mx, fy + my
        bg = i1 <= 1.0
        fx = jnp.where(bg, 0.0, fx)
        fy = jnp.where(bg, 0.0, fy)
        valid = (i0 > 1.0) | (i1 > 1.0)
        return fx, fy, valid

    def whole(i0, i1, affine):
        return post(tvl1_flow(i0, i1, params), i0, i1, affine)

    return jax.jit(whole)


@functools.lru_cache(maxsize=64)
def _affine_warper(h: int, w: int, oh: int, ow: int):
    return jax.jit(
        lambda im, aff: affine_warp(im, aff, out_shape=(oh, ow))
    )


def _solve_mode(features: bool, output_type: str) -> str:
    if features:
        return "features_flow" if output_type == "flow" else "features_map"
    return "map" if output_type == "map" else "displacement"


def solve_wrapper(
    f0_roi: np.ndarray,
    f1_roi: np.ndarray,
    affine: np.ndarray,
    im_args: Dict,
    args: Mapping,
    features: bool,
    roi_vec: Tuple[Roi, Roi],
    *,
    write_outputs: bool = True,
) -> Dict[str, np.ndarray]:
    """Solve one ROI pair and emit its outputs (ref: src/optflow.cpp:395-496).

    Returns {"flow_x", "flow_y", "valid"} as numpy arrays.
    """
    params = TVL1Params.from_config(im_args, args)
    output_type = str(cfg_get(im_args, args, "output_type", "map"))
    mode = _solve_mode(features, output_type)
    h, w = f0_roi.shape
    solver = _roi_solver(h, w, params, mode)
    fx, fy, valid = solver(
        jnp.asarray(f0_roi, jnp.float32),
        jnp.asarray(f1_roi, jnp.float32),
        jnp.asarray(affine, jnp.float32),
    )
    fx = np.asarray(fx)
    fy = np.asarray(fy)
    valid = np.asarray(valid)

    if output_type in ("map", "flow") and write_outputs:
        base = str(im_args.get("output", "")) + str(
            im_args.get("output_suffix", "")
        )
        write_float_tiff(base + "_x.tiff", fx)
        write_float_tiff(base + "_y.tiff", fy)

    if output_type == "random_points":
        scale = float(cfg_get(im_args, args, "scale", 0.5))
        im_args["point_matches"] = random_points(
            fx,
            fy,
            valid,
            roi_vec,
            npoints=int(cfg_get(im_args, args, "npoints", 25)),
            inv_scale=1.0 / scale,
            features=features,
            debug=bool(args.get("debug", False)),
            point_matches=im_args.get("point_matches"),
        )
    return {"flow_x": fx, "flow_y": fy, "valid": valid}


def solve_rois(
    frame0: np.ndarray,
    frame1: np.ndarray,
    rois: Mapping[str, object],
    im_args: Dict,
    args: Mapping,
    aligner: Optional[Aligner] = None,
    *,
    write_outputs: bool = True,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-pair ROI loop (ref: src/optflow.cpp:312-392).

    Iterates ROI keys in sorted order (jsoncpp getMemberNames order) so the
    features-persistence behavior matches the reference. Returns per-key
    result dicts.
    """
    features = resolve_features(im_args, args)
    affine = IDENTITY_AFFINE
    warped_frame1: Optional[np.ndarray] = None
    results: Dict[str, Dict[str, np.ndarray]] = {}

    size_mismatch = frame0.shape != frame1.shape

    for roi_key in sorted(rois.keys()):
        if roi_key in ("top", "bottom"):
            im_args["output_suffix"] = "_" + roi_key
        else:
            im_args["output_suffix"] = ""

        if roi_key == "custom_diff":
            if features:
                print(
                    "Features isn't compatible with different ROIs for each "
                    "image.\n Ignoring features.",
                    file=sys.stderr,
                )
            roi_0, roi_1 = rois[roi_key]  # type: ignore[misc]
            if roi_0.shape != roi_1.shape:
                # The reference would crash inside the GPU solver; we crop
                # both rects to the common size instead.
                ch = min(roi_0.height, roi_1.height)
                cw = min(roi_0.width, roi_1.width)
                roi_0 = Roi(roi_0.x, roi_0.y, cw, ch)
                roi_1 = Roi(roi_1.x, roi_1.y, cw, ch)
            f0 = frame0[roi_0.slices()]
            f1 = frame1[roi_1.slices()]
            results[roi_key] = solve_wrapper(
                f0,
                f1,
                IDENTITY_AFFINE,
                im_args,
                args,
                False,
                (roi_0, roi_1),
                write_outputs=write_outputs,
            )
            continue

        if features or size_mismatch or roi_key == "default":
            if (size_mismatch or roi_key == "default") and not features:
                print(
                    "Rows or columns differ between frames no ROI selected, "
                    "reverting to features even though it wasn't selected.",
                    file=sys.stderr,
                )
            if warped_frame1 is None:
                if aligner is not None:
                    affine = np.asarray(
                        aligner(frame1, frame0, im_args, args),
                        dtype=np.float32,
                    )
                else:
                    affine = IDENTITY_AFFINE
                oh, ow = frame0.shape
                h1, w1 = frame1.shape
                warper = _affine_warper(h1, w1, oh, ow)
                warped_frame1 = np.asarray(
                    warper(
                        jnp.asarray(frame1, jnp.float32),
                        jnp.asarray(affine, jnp.float32),
                    )
                )
            features = True
            f1_full = warped_frame1
        else:
            f1_full = frame1

        roi: Roi = rois[roi_key]  # type: ignore[assignment]
        f0 = frame0[roi.slices()]
        f1 = f1_full[roi.slices()]
        results[roi_key] = solve_wrapper(
            f0,
            f1,
            affine,
            im_args,
            args,
            features,
            (roi, roi),
            write_outputs=write_outputs,
        )

    return results
