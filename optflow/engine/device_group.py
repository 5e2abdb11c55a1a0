"""Device-resident group pipeline for ``random_points`` jobs.

The batch runner's full-field group solve uploads f32 ROI stacks and
downloads full flow/valid fields per group, although a ``random_points``
job needs only a few sampled points per pair on the host. The reference
has the same structural cost (download + findNonZero per pair,
src/optflow.cpp:475-494).

This pipeline keeps the whole group on device:

- unique frames upload ONCE per job (not per group) through a device
  frame cache, as float16 where that is LOSSLESS (scales 1.0/0.5:
  quarter-integer intensities <= 255.75 are exactly representable) and
  float32 otherwise — see :func:`frame_upload_dtype`;
- ROI slicing, pair gathering, feature pre-alignment, flow
  post-processing (map composition, background zero-mask, union valid
  mask — src/optflow.cpp:411-493 semantics) and POINT SAMPLING all run
  on device;
- sampling is a top-k over per-pixel random priorities: exactly a
  uniform draw of ``npoints`` valid pixels without replacement (the
  reference's findNonZero + shuffle + take-front, src/optflow.cpp
  :522-572), deterministic under ``debug`` via a fixed PRNG key;
- ONE packed readback per group carries samples + valid counts.

Engages for single-device meshes; multi-device jobs keep the sharded
full-field path.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optflow.core.config import TVL1Params
from optflow.engine.rois import Roi

import os as _os

_FRAME_DTYPE_ENV = _os.environ.get("OPTFLOW_FRAME_DTYPE")


def frame_upload_dtype(scale: float) -> np.dtype:
    """Upload dtype for decoded frames at a given job scale.

    float16 is LOSSLESS exactly when the decode produces quarter-integer
    intensities <= 255.75 (scale 1.0: integers; scale 0.5: 2x2
    area-averages of uint8). Other scales produce finer fractions that
    f16 would round near bright pixels (ulp 0.125 above 128), silently
    diverging from the host path — those upload as float32
    OPTFLOW_FRAME_DTYPE overrides for A/B."""
    if _FRAME_DTYPE_ENV:
        return np.dtype(_FRAME_DTYPE_ENV)
    return np.dtype(
        np.float16 if float(scale) in (1.0, 0.5) else np.float32
    )


class DeviceFrameCache:
    """id(ndarray) -> on-device frame (f16/f32 per the upload
    dtype rule), bounded FIFO.

    The host FrameCache hands the SAME ndarray object to every pair that
    reuses a (path, scale), so array identity keys device residency; the
    host array is retained alongside so its id can't be recycled. 256
    entries of a 0.5 Mpx f16 frame ~= 128 MB of device memory."""

    def __init__(self, capacity: int = 256):
        self._cap = capacity
        self._entries: Dict[int, Tuple[np.ndarray, object]] = {}
        self._order: List[int] = []

    def get(self, arr: np.ndarray, dtype=np.float16):
        key = id(arr)
        hit = self._entries.get(key)
        if hit is not None:
            return hit[1]
        dev = jax.device_put(np.asarray(arr, dtype))
        self._insert(key, arr, dev)
        return dev

    def get_many(self, arrs: Sequence[np.ndarray],
                 dtype=np.float16) -> List[object]:
        """Handles for a batch of frames; the MISSES upload as ONE
        stacked device_put (one transfer instead of one per frame) and
        are sliced apart on device."""
        handles: List[object] = [None] * len(arrs)
        miss: List[int] = []
        for j, arr in enumerate(arrs):
            hit = self._entries.get(id(arr))
            if hit is not None:
                handles[j] = hit[1]
            else:
                miss.append(j)
        if miss:
            stacked = jax.device_put(
                np.stack([np.asarray(arrs[j], dtype) for j in miss])
            )
            for pos, j in enumerate(miss):
                dev = stacked[pos]
                handles[j] = dev
                self._insert(id(arrs[j]), arrs[j], dev)
        return handles

    def _insert(self, key: int, arr: np.ndarray, dev) -> None:
        self._entries[key] = (arr, dev)
        self._order.append(key)
        if len(self._order) > self._cap:
            old = self._order.pop(0)
            self._entries.pop(old, None)


def _bucket(n: int) -> int:
    """Pad pair counts to small buckets so straggler groups don't each
    compile fresh programs."""
    b = 4
    while b < n:
        b *= 2
    return b


@functools.lru_cache(maxsize=256)
def _stack_fn(u: int, fh: int, fw: int, dt: str):
    """Device-side stack of u cached frame handles -> (u, fh, fw)."""

    def f(*frames):
        return jnp.stack([fr.astype(dt) for fr in frames])

    return jax.jit(f)


def stack_frames(handles: Sequence, fh: int, fw: int):
    """Stack per-frame device arrays into one (U_bucket, fh, fw) array
    on device (no host roundtrip). Pads with the first frame; mixed
    stored dtypes (a scale change mid-job) promote to the widest."""
    u = _bucket(len(handles))
    padded = list(handles) + [handles[0]] * (u - len(handles))
    dt = str(np.result_type(*[np.dtype(h.dtype) for h in padded]))
    return _stack_fn(u, fh, fw, dt)(*padded), u


@functools.lru_cache(maxsize=256)
def _gather_fn(
    u: int,
    fh: int,
    fw: int,
    rois: Tuple[Tuple[int, int, int, int], ...],  # (y, x, h, w) per ROI
    features: bool,
    n: int,
):
    """jit: ROI stacks for every (roi, pair) from the device frame stack.

    Returns (R*n, h, w) f32 i0/i1 stacks ordered ROI-major (roi r's
    pairs are rows [r*n, (r+1)*n)). With ``features``, frame1 comes from
    the pre-warped per-pair frames instead of the frame stack."""
    hh, ww = rois[0][2], rois[0][3]
    assert all((r[2], r[3]) == (hh, ww) for r in rois)

    def f(frames, f0_idx, f1_idx, warped):
        frames = frames.astype(jnp.float32)
        f0 = frames[f0_idx]  # (n, fh, fw)
        f1 = warped if features else frames[f1_idx]
        i0 = jnp.concatenate(
            [
                jax.lax.slice(f0, (0, y, x), (n, y + hh, x + ww))
                for (y, x, _h, _w) in rois
            ]
        )
        i1 = jnp.concatenate(
            [
                jax.lax.slice(f1, (0, y, x), (n, y + hh, x + ww))
                for (y, x, _h, _w) in rois
            ]
        )
        return i0, i1

    return jax.jit(f)


@functools.lru_cache(maxsize=256)
def _post_sample_fn(h: int, w: int, mode: str, npoints: int, n: int):
    """jit: flow post-processing + uniform valid-pixel sampling + packed
    readback payload.

    Post-processing mirrors engine.pair._roi_solver's post() — the
    reference's solve_wrapper composition (src/optflow.cpp:411-493):
    map/feature-affine composition, background zero-mask (frame1 <= 1),
    union valid mask. Sampling: per-pixel U(0,1) priorities, invalid
    pixels sent to -1, top-k of npoints -> a uniform draw without
    replacement; count = min(npoints, n_valid).

    Output: (n, npoints * 4 + 1) f32 rows of
    [px, py, out_x, out_y] * npoints + [count]."""
    from optflow.ops.warp import affine_warp_shift

    features = mode.startswith("features")

    def f(flow, i0s, i1s, affines, key):
        fx = flow[..., 0]
        fy = flow[..., 1]
        if mode != "displacement":
            mx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
            my = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        if features:
            ax = fx + mx
            ay = fy + my
            nx, _ = jax.vmap(affine_warp_shift)(ax, affines)
            ny, _ = jax.vmap(affine_warp_shift)(ay, affines)
            if mode == "features_flow":
                fx, fy = nx - mx, ny - my
            else:
                fx, fy = nx, ny
        elif mode == "map":
            fx, fy = fx + mx, fy + my
        bg = i1s <= 1.0
        fx = jnp.where(bg, 0.0, fx)
        fy = jnp.where(bg, 0.0, fy)
        valid = (i0s > 1.0) | (i1s > 1.0)

        pri = jnp.where(valid, jax.random.uniform(key, valid.shape), -1.0)
        _top, idx = jax.lax.top_k(pri.reshape(n, h * w), npoints)
        px = (idx % w).astype(jnp.float32)
        py = (idx // w).astype(jnp.float32)
        fxv = jnp.take_along_axis(fx.reshape(n, h * w), idx, axis=1)
        fyv = jnp.take_along_axis(fy.reshape(n, h * w), idx, axis=1)
        count = jnp.minimum(
            jnp.sum(valid, axis=(1, 2)), npoints
        ).astype(jnp.float32)
        samples = jnp.stack([px, py, fxv, fyv], axis=2).reshape(n, -1)
        return jnp.concatenate([samples, count[:, None]], axis=1)

    return jax.jit(f)


def solve_group_on_device(
    frames_dev,  # (U, fh, fw) f16 device stack
    f0_idx: np.ndarray,
    f1_idx: np.ndarray,
    rois: Sequence[Tuple[str, Roi]],  # same-shape ROIs, ordered
    params: TVL1Params,
    mode: str,
    npoints: int,
    affines_dev=None,  # (n, 2, 3) f32 device (features groups)
    warped_dev=None,  # (n, fh, fw) f32 device (features groups)
    debug: bool = False,
    seed: int = 0,
):
    """Solve all same-shape ROIs of a pair group fully on device.

    Returns the (R*n, npoints*4+1) packed payload (np.asarray it: ONE
    transfer)."""
    from optflow.ops.tvl1 import tvl1_flow_batched

    u, fh, fw = frames_dev.shape
    n = len(f0_idx)
    features = mode.startswith("features")
    roi_key = tuple(
        (r.y, r.x, r.height, r.width) for _name, r in rois
    )
    h, w = rois[0][1].shape
    gather = _gather_fn(u, fh, fw, roi_key, features, n)
    warped_arg = (
        warped_dev if warped_dev is not None
        else jnp.zeros((n, fh, fw), jnp.float32)
    )
    i0s, i1s = gather(
        frames_dev, jnp.asarray(f0_idx), jnp.asarray(f1_idx), warped_arg
    )
    rn = len(roi_key) * n
    flow = tvl1_flow_batched(i0s, i1s, params)
    if affines_dev is None:
        affines_dev = jnp.broadcast_to(
            jnp.eye(2, 3, dtype=jnp.float32), (n, 2, 3)
        )
    affs = jnp.concatenate([affines_dev] * len(roi_key))
    key = jax.random.PRNGKey(0 if debug else int(seed))
    return _post_sample_fn(h, w, mode, npoints, rn)(flow, i0s, i1s, affs, key)


def unpack_samples(
    packed_np: np.ndarray,  # (R*n, npoints*4+1) from np.asarray(packed)
    n: int,
    npoints: int,
):
    """Split the (R*n, npoints*4+1) packed payload back into
    per-(roi, pair) sample arrays:
    returns (samples (R, n, npoints, 4), counts (R, n) int — n includes
    bucket padding)."""
    rn = packed_np.shape[0]
    r = rn // n
    samples = packed_np[:, : npoints * 4].reshape(r, n, npoints, 4)
    counts = packed_np[:, npoints * 4].reshape(r, n).astype(np.int64)
    return samples, counts


def matches_from_samples(
    samples: np.ndarray,  # (npoints, 4): px, py, out_x, out_y
    count: int,
    roi: Roi,
    inv_scale: float,
    features: bool,
    point_matches: Optional[Dict] = None,
) -> Dict:
    """Host-side assembly of one (pair, roi)'s matches from the device
    samples — the coordinate math of engine.sampler.random_points
    (src/optflow.cpp:522-572 semantics), including the dummy match for
    an empty valid mask."""
    if point_matches is None or not point_matches:
        point_matches = {"p": [[], []], "q": [[], []], "w": []}
    if count == 0:
        point_matches["p"][0].append(-1)
        point_matches["p"][1].append(-1)
        point_matches["q"][0].append(-1)
        point_matches["q"][1].append(-1)
        point_matches["w"].append(0)
        return point_matches
    for px, py, fx, fy in samples[:count]:
        point_matches["w"].append(1)
        point_matches["p"][0].append((float(px) + roi.x) * inv_scale)
        point_matches["p"][1].append((float(py) + roi.y) * inv_scale)
        if features:
            point_matches["q"][0].append((float(fx) + roi.x) * inv_scale)
            point_matches["q"][1].append((float(fy) + roi.y) * inv_scale)
        else:
            point_matches["q"][0].append(
                (float(px) + roi.x + float(fx)) * inv_scale
            )
            point_matches["q"][1].append(
                (float(py) + roi.y + float(fy)) * inv_scale
            )
    return point_matches
