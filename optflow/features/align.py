"""Feature-based pre-alignment: find_alignment.

Reimplements the reference's find_alignment (src/features.cpp:46-167):
detect + describe on both frames (ORB-class for ``features == 1``,
SURF-class for ``features == 2``, default SURF), k=2 brute-force matching,
Lowe ratio test, homography estimation by the configured ``homo`` method
with ``ransac`` reprojection threshold, then the sanity gates:

- fewer than 11 good matches -> identity + "Not enough matches"
  (src/features.cpp:157-166)
- no homography or either diagonal scale term deviating more than 20%
  from 1 -> identity + warning (src/features.cpp:134-147)
- otherwise the affine is the top two rows of the homography
  (src/features.cpp:154) — the projective row is dropped, as in the
  reference.

The returned 2x3 affine maps the first argument's coordinates into the
second argument's space (the engine calls find_alignment(frame1, frame0),
src/optflow.cpp:373, then warps frame1 with it).

The whole pipeline — detection, description, matching, RANSAC, sanity
gates — runs on device inside ONE jitted function with the gates traced
(identity selected with jnp.where), so a pair costs a single host readback
and the function vmaps over a batch of pairs
(:func:`find_alignment_batched_device` — used by the batched job runner).

The reference's SURF pad-to-multiple-of-64 workaround
(src/features.cpp:70-78) is a CUDA-SURF implementation detail and is not
needed here.
"""

from __future__ import annotations

import functools
import sys
from typing import Mapping, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optflow.core.config import (
    MatchParams,
    OrbParams,
    SurfParams,
    cfg_get,
    feature_type,
    ORB_TYPE,
    SURF_TYPE,
)
from optflow.features.descriptors import orb_descriptors, surf_descriptors
from optflow.features.detect import fast_keypoints, hessian_keypoints
from optflow.features.match import knn_match2, ratio_filter
from optflow.features.ransac import find_homography

IDENTITY = np.array([[1.0, 0, 0], [0, 1.0, 0]], dtype=np.float32)


class AlignResult(NamedTuple):
    """Device-side alignment outcome for one pair."""

    affine: jnp.ndarray  # (2, 3) f32 — identity when any gate fired
    n_good: jnp.ndarray  # () i32 ratio-test survivors
    enough: jnp.ndarray  # () bool  n_good > 10 (src/features.cpp:130)
    homo_ok: jnp.ndarray  # () bool homography found & zoom gate passed
    H: jnp.ndarray  # (3, 3) raw homography (for debug prints)


def _detect_capacity(ftype: int, h: int, w: int, orb: OrbParams, surf: SurfParams) -> int:
    if ftype == ORB_TYPE:
        return min(max(int(orb.nfeatures), 64), 2048)
    # Upper clamp 1536 (was 4096): descriptor cost is linear in CAPACITY
    # (fixed shapes), and the production strip at the DEFAULT
    # hessianThreshold=400 yields ~1430 valid keypoints (r5 measurement)
    # — the reference's keypointsRatio * px buffer bound (0.01 * 262144
    # = 2621 here, src/features.cpp:34-44 semantics) spent 45% of the
    # describe stage on empty slots. Production runs threshold 1600
    # (gen_cross_file_list defaults) with far fewer keypoints still.
    # Keypoints remain the top-K by response, so extremely dense images
    # lose only their weakest detections.
    return int(np.clip(surf.keypoints_ratio * h * w, 256, 1536))


def _detect_describe_device(im: jnp.ndarray, ftype: int, orb: OrbParams, surf: SurfParams):
    h, w = im.shape
    cap = _detect_capacity(ftype, h, w, orb, surf)
    if ftype == ORB_TYPE:
        kps = fast_keypoints(
            im,
            fast_threshold=orb.fast_threshold,
            scale_factor=orb.scale_factor,
            nlevels=orb.nlevels,
            capacity=cap,
            edge_threshold=orb.edge_threshold,
        )
        desc = orb_descriptors(im, kps)
        return kps, desc, True
    kps = hessian_keypoints(
        im,
        hessian_threshold=surf.hessian_threshold,
        n_octaves=surf.n_octaves,
        n_octave_layers=surf.n_octave_layers,
        capacity=cap,
    )
    from optflow.features.descriptors import surf_orient_describe

    # fused: one gradient-patch extraction feeds orientation + descriptors
    angles, desc = surf_orient_describe(im, kps, upright=surf.upright)
    kps = kps._replace(angle=angles)
    return kps, desc, False


def _match_and_fit(
    kps0, desc0, kps1, desc1, binary: bool, mp: MatchParams
) -> AlignResult:
    """Per-pair half of the alignment: k=2 matching, ratio test, RANSAC
    homography and the reference's sanity gates, on precomputed
    keypoints/descriptors."""
    matches = knn_match2(desc0, kps0.valid, desc1, kps1.valid, binary=binary)
    good = ratio_filter(matches, mp.ratio)
    n_good = jnp.sum(good).astype(jnp.int32)
    enough = n_good > 10  # src/features.cpp:130

    p0 = jnp.stack([kps0.x, kps0.y], axis=1)
    p1 = jnp.stack([kps1.x, kps1.y], axis=1)[matches.idx]

    res = find_homography(
        p0, p1, good, thresh=float(mp.ransac), method=int(mp.homo)
    )
    H = res.H
    zoom_ok = (
        (jnp.abs(1.0 - H[0, 0]) <= mp.max_zoom_deviation)
        & (jnp.abs(1.0 - H[1, 1]) <= mp.max_zoom_deviation)
    )  # src/features.cpp:134-147
    homo_ok = res.ok & zoom_ok & jnp.all(jnp.isfinite(H))

    use = enough & homo_ok
    affine = jnp.where(
        use, H[0:2, 0:3], jnp.asarray(IDENTITY)
    ).astype(jnp.float32)
    return AlignResult(affine, n_good, enough, homo_ok, H)


@functools.partial(
    jax.jit, static_argnames=("ftype", "orb", "surf", "mp")
)
def find_alignment_device(
    src: jnp.ndarray,  # (H, W) frame whose coords the affine maps FROM
    dst: jnp.ndarray,  # (H', W') target coordinate space
    ftype: int,
    orb: OrbParams,
    surf: SurfParams,
    mp: MatchParams,
) -> AlignResult:
    """Whole alignment pipeline on device; no host syncs, vmappable."""
    kps0, desc0, binary = _detect_describe_device(src, ftype, orb, surf)
    kps1, desc1, _ = _detect_describe_device(dst, ftype, orb, surf)
    return _match_and_fit(kps0, desc0, kps1, desc1, binary, mp)


@functools.partial(
    jax.jit, static_argnames=("ftype", "orb", "surf", "mp")
)
def find_alignment_indexed(
    frames: jnp.ndarray,  # (F, H, W) UNIQUE frames
    src_idx: jnp.ndarray,  # (N,) int32 — frame whose coords map FROM
    dst_idx: jnp.ndarray,  # (N,) int32 — target coordinate space
    ftype: int,
    orb: OrbParams,
    surf: SurfParams,
    mp: MatchParams,
) -> AlignResult:
    """Frame-deduplicated batched alignment: detect + describe run ONCE
    per unique frame, matching + RANSAC per pair. Production pair lists
    chain sections (z-distance <= 3 graphs reuse every frame in up to 6
    pairs, support_scripts/gen_cross_file_list.py), so this halves-plus
    the dominant detect/describe cost vs the per-pair pipeline."""
    binary = ftype == ORB_TYPE

    kps, desc = jax.vmap(
        lambda im: _detect_describe_device(im, ftype, orb, surf)[:2]
    )(frames)

    def per_pair(si, di):
        k0 = jax.tree.map(lambda a: a[si], kps)
        k1 = jax.tree.map(lambda a: a[di], kps)
        return _match_and_fit(k0, desc[si], k1, desc[di], binary, mp)

    return jax.vmap(per_pair)(src_idx, dst_idx)


@functools.partial(
    jax.jit, static_argnames=("ftype", "orb", "surf", "mp")
)
def find_alignment_batched_device(
    srcs: jnp.ndarray,  # (N, H, W)
    dsts: jnp.ndarray,  # (N, H', W')
    ftype: int,
    orb: OrbParams,
    surf: SurfParams,
    mp: MatchParams,
) -> AlignResult:
    """vmapped :func:`find_alignment_device` over a leading pair axis —
    the batched job runner's pre-alignment (everything is fixed-capacity,
    so the vmap is a pure batch dimension)."""
    return jax.vmap(
        lambda a, b: find_alignment_device(a, b, ftype, orb, surf, mp)
    )(srcs, dsts)


def resolve_feature_params(
    im_args: Mapping, args: Mapping
) -> Tuple[int, OrbParams, SurfParams, MatchParams]:
    """Resolve the static (hashable) parameter bundle for the device
    aligner from the job config precedence chain."""
    return (
        feature_type(im_args, args),
        OrbParams.from_config(im_args, args),
        SurfParams.from_config(im_args, args),
        MatchParams.from_config(im_args, args),
    )


def print_align_warnings(
    enough: bool, homo_ok: bool, H: np.ndarray, debug: bool
) -> None:
    """Reproduce the reference's per-pair stderr/stdout diagnostics
    (src/features.cpp:134-147,157-166)."""
    if not enough:
        print("Not enough matches. Using no transformation")
        return
    if not homo_ok:
        print(
            "More than twenty percent variance in zoom or no homography "
            "found, this is probably an error, ignoring the transformation."
        )
    if debug:
        print(H)


def find_alignment(
    src: np.ndarray,
    dst: np.ndarray,
    im_args: Mapping,
    args: Mapping,
) -> np.ndarray:
    """Estimate the 2x3 affine mapping src coordinates into dst space.

    Host-facing wrapper: one device dispatch, one readback (the round-trip
    pattern the reference's per-stage downloads forced is gone)."""
    debug = bool(args.get("debug", False))
    ftype, orb, surf, mp = resolve_feature_params(im_args, args)

    res = find_alignment_device(
        jnp.asarray(src, jnp.float32),
        jnp.asarray(dst, jnp.float32),
        ftype,
        orb,
        surf,
        mp,
    )
    # single host transfer of the full result bundle
    affine, n_good, enough, homo_ok, H = jax.device_get(res)

    if debug:
        print(f"Number of good features: {int(n_good)}")
    print_align_warnings(bool(enough), bool(homo_ok), H, debug)
    if not (bool(enough) and bool(homo_ok)):
        return IDENTITY.copy()
    return np.asarray(affine, dtype=np.float32)
