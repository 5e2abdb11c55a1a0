"""Batched job runner: same-shape pairs solved together under one jit.

The reference's pair loop is strictly sequential — one GPU solve per pair
(src/optflow.cpp:87-171). Here throughput comes from batching: pairs
whose frames, ROI set, solver parameters, and output type match are
grouped, their ROI slices stacked along a leading batch dimension, and
solved in a single vmapped dispatch (which also shards across a device
mesh via the dist.PairScheduler layout). Host-side post-processing
(TIFF writing, point sampling, match accumulation) stays per-pair and
preserves the reference's ordering and upload-batching semantics.

Feature pre-alignment pairs DO batch: _batched_prealigner runs detect /
describe / match / RANSAC across the group and the batched solver takes a
per-pair (2, 3) affine. Pairs that still can't batch — custom_diff ROIs,
mismatched frame shapes — fall back to the sequential solve_rois path,
so behavior is identical and batching is purely an optimization.

Enable via the job key ``pair_batch`` (int > 1) or call
:func:`run_job_batched` directly.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optflow.core.config import JobConfig, TVL1Params, cfg_get, resolve_features
from optflow.core.imgio import ImageReadError, write_float_tiff
from optflow.engine.journal import JobJournal, pair_key, pair_key_aliases
from optflow.engine.pair import Aligner, _solve_mode, solve_rois
from optflow.engine.rois import Roi, resolve_rois
from optflow.engine.runner import FrameCache
from optflow.engine.sampler import move_pm, random_points
from optflow.sinks.http import make_sink
from optflow.utils.metrics import StageTimer

def _batched_solver(h: int, w: int, params: TVL1Params, mode: str, mesh):
    """Batched ROI solve + flow post-processing. ``mode`` follows
    engine.pair._solve_mode; features_* modes take a (N, 2, 3) affine and
    reproduce solve_wrapper's map composition (src/optflow.cpp:411-443)."""
    from optflow.ops.tvl1 import tvl1_flow_batched
    from optflow.ops.warp import affine_warp

    features = mode.startswith("features")

    def f(i0s, i1s, affines):
        flow = tvl1_flow_batched(i0s, i1s, params)
        fx = flow[..., 0]
        fy = flow[..., 1]
        if mode != "displacement":
            mx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
            my = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        if features:
            ax = fx + mx
            ay = fy + my
            nx = jax.vmap(affine_warp)(ax, affines)
            ny = jax.vmap(affine_warp)(ay, affines)
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
        return fx, fy, valid

    if mesh is None:
        return jax.jit(f), None
    from jax.sharding import NamedSharding, PartitionSpec as P

    # shard_map (not GSPMD annotations): each device runs the batched
    # solver on its local slice of the pairs axis
    sharded = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(P("pairs"), P("pairs"), P("pairs")),
        out_specs=(P("pairs"), P("pairs"), P("pairs")),
        check_vma=False,  # solver loop carries mix replicated/varying
    )
    sharding = NamedSharding(mesh, P("pairs"))
    return jax.jit(sharded), sharding


@functools.lru_cache(maxsize=128)
def _batched_prealigner(h: int, w: int, ftype, orb, surf, mp):
    """Batched feature pre-alignment + frame-1 warp: the device equivalent
    of find_alignment + cv::cuda::warpAffine (src/optflow.cpp:366-377),
    one dispatch for the whole group. FRAME-DEDUPLICATED: detect +
    describe run once per unique frame (production pair graphs reuse
    every frame in up to 6 pairs, gen_cross_file_list.py z-distance <= 3)
    and matching/RANSAC per pair via index arrays."""
    from optflow.features.align import find_alignment_indexed
    from optflow.ops.warp import affine_warp_shift

    def f(frames, f1_idx, f0_idx):
        # affine maps frame1 -> frame0 space: src = frame1, dst = frame0.
        # Shift-compose warp (no gathers): the vmapped gather warp
        # measured 170 ms device for 16 frames — the feature path's
        # single largest cost (r5). The per-image clamp counts ride the
        # outputs; callers re-warp offending images with the exact
        # gather warp (rare: the residual contract covers production
        # affines, ops/warp.py AFFINE_SHIFT_MAX).
        res = find_alignment_indexed(
            frames, f1_idx, f0_idx, ftype, orb, surf, mp
        )
        warped, ncl = jax.vmap(affine_warp_shift)(
            frames[f1_idx], res.affine
        )
        return (res.affine, warped, res.n_good, res.enough, res.homo_ok,
                res.H, ncl)

    # pre-alignment runs unsharded (single dispatch, small outputs); a
    # pairs-axis shard_map is a straightforward extension once feature
    # groups exceed a single device's appetite. lru-cached: a fresh
    # jax.jit wrapper per group re-traced the large detect/describe
    # program every group (code-review r5 #5).
    return jax.jit(f)


def _fix_clamped_warps(frames_d, f1_idx, warped_d, aff_d, ncl_np):
    """Re-warp images whose shift-compose affine warp clamped tap
    shifts (affine beyond the AFFINE_SHIFT_MAX residual contract —
    rare; the 20%-zoom sanity gate admits such affines in principle)
    with the EXACT gather warp, splicing on device. Keeps the batched
    path's output identical to the sequential path's for
    out-of-contract affines (code-review r5 #1)."""
    from optflow.ops.warp import affine_warp

    idx = np.nonzero(ncl_np > 0)[0]
    if len(idx) == 0:
        return warped_d
    print(
        f"batch_runner: exact re-warp of {len(idx)} frames whose affine "
        f"exceeded the shift-warp residual contract",
        file=sys.stderr,
    )
    for j in idx:
        exact = affine_warp(
            frames_d[int(f1_idx[j])].astype(jnp.float32), aff_d[int(j)]
        )
        warped_d = warped_d.at[int(j)].set(exact)
    return warped_d


def _dedup_frames(tasks, n_pad: int):
    """Identity-keyed frame dedup shared by the host and device group
    paths: the FrameCache/PrefetchLoader hand the SAME ndarray to every
    pair reusing a (path, scale), so id() keys one detect/describe/
    upload per unique section. Returns (uniq, f0_idx, f1_idx)."""
    uniq: List[np.ndarray] = []
    uniq_ids: Dict[int, int] = {}
    f0_idx = np.zeros(n_pad, np.int32)
    f1_idx = np.zeros(n_pad, np.int32)

    def slot(arr: np.ndarray) -> int:
        key = id(arr)
        if key not in uniq_ids:
            uniq_ids[key] = len(uniq)
            uniq.append(arr)
        return uniq_ids[key]

    for j, t in enumerate(tasks):
        f0_idx[j] = slot(t.frame0)
        f1_idx[j] = slot(t.frame1)
    return uniq, f0_idx, f1_idx


_batched_cache: Dict[Tuple, object] = {}

def _get_batched_solver(h, w, params, mode, mesh):
    key = (h, w, params, mode, id(mesh))
    if key not in _batched_cache:
        _batched_cache[key] = _batched_solver(h, w, params, mode, mesh)
    return _batched_cache[key]


@dataclasses.dataclass
class _Task:
    index: int
    im_data: Dict
    # references into the FrameCache's decoded arrays (never mutated, so
    # no defensive copies — array IDENTITY keys both the host-side
    # detect/describe dedup and the device frame cache)
    frame0: np.ndarray
    frame1: np.ndarray
    rois: Dict[str, Roi]


def _group_key(im_data, args, frame0, frame1, rois, cfg: JobConfig):
    from optflow.features.align import resolve_feature_params

    params = TVL1Params.from_config(im_data, args)
    roi_sig = tuple(sorted((k, v) for k, v in rois.items()))
    features = resolve_features(im_data, args) or any(
        k == "default" for k in rois
    )
    fsig = resolve_feature_params(im_data, args) if features else None
    return (
        frame0.shape,
        frame1.shape,
        params,
        cfg.output_type(im_data),
        roi_sig,
        features,
        fsig,
        # per-image npoints overrides must not inherit the group
        # leader's count in the device sampler (code-review r5 #3)
        cfg.npoints(im_data),
        cfg.scale(im_data),
    )


def _batchable(im_data, args, frame0, frame1, rois, can_batch_features) -> bool:
    if frame0.shape != frame1.shape:
        return False  # forces the feature path (src/optflow.cpp:366-377)
    features = resolve_features(im_data, args) or any(
        k == "default" for k in rois
    )
    if features and not can_batch_features:
        return False  # a custom host aligner can't run inside the batch
    for k, v in rois.items():
        if k == "custom_diff" or not isinstance(v, Roi):
            return False
    return True


def run_job_batched(
    args: Dict,
    *,
    aligner: Optional[Aligner] = None,
    sink=None,
    loader=None,
    write_outputs: bool = True,
    pair_batch: Optional[int] = None,
    mesh=None,
) -> Dict:
    """Batched equivalent of runner.run_job (same stats contract).

    With more than one local device and no explicit ``mesh``, a pairs-axis
    mesh over all devices is built automatically so group solves shard
    data-parallel (pair_batch is rounded up to a multiple of the axis)."""
    cfg = JobConfig(args)
    # feature groups batch through the device aligner; a caller-supplied
    # host aligner (test hook / custom matcher) forces those pairs onto the
    # sequential path so its behavior is preserved
    can_batch_features = aligner is None or getattr(
        aligner, "__name__", ""
    ) == "default_aligner"
    if pair_batch is None:
        pair_batch = int(args.get("pair_batch", 8))
    if mesh is None and jax.device_count() > 1:
        from optflow.dist.mesh import make_pair_mesh

        mesh = make_pair_mesh()
    n_shards = mesh.shape["pairs"] if mesh is not None else 1
    if n_shards > 1:
        pair_batch = -(-pair_batch // n_shards) * n_shards
    prefetch = None
    if loader is None and args.get("prefetch", True):
        from optflow.engine.prefetch import make_prefetch_loader

        prefetch = make_prefetch_loader(args)
        loader = prefetch
    cache = FrameCache(loader)
    if sink is None:
        sink = make_sink(args)
    journal = JobJournal(str(args["journal"])) if args.get("journal") else None
    completed = (
        journal.completed_keys(cfg.output_type({})) if journal else set()
    )
    timer = StageTimer()

    stats = {"pairs": 0, "skipped": 0, "uploads": 0, "matches": 0,
             "resumed": 0, "batched": 0, "sequential": 0}
    batch_size = cfg.batch_size()
    upload_state = {"last": 0, "pending": False}

    def maybe_flush(i: int, force: bool = False):
        if not upload_state["pending"]:
            return
        if force or i > upload_state["last"] + batch_size:
            batch = args.get("point_matches", [])
            stats["matches"] += sum(
                len(m["matches"].get("w", [])) for m in batch
            )
            with timer.stage("sink"):
                sink.put(batch)
            args["point_matches"] = []
            stats["uploads"] += 1
            upload_state["last"] = i
            upload_state["pending"] = False
            if journal:
                journal.record_flush()

    def post_process(
        task: _Task, roi_key: str, roi: Roi, fx, fy, valid, features: bool
    ):
        im_data = task.im_data
        suffix = "_" + roi_key if roi_key in ("top", "bottom") else ""
        im_data["output_suffix"] = suffix
        output_type = cfg.output_type(im_data)
        if output_type in ("map", "flow") and write_outputs:
            base = str(im_data.get("output", "")) + suffix
            write_float_tiff(base + "_x.tiff", fx)
            write_float_tiff(base + "_y.tiff", fy)
        if output_type == "random_points":
            scale = cfg.scale(im_data)
            im_data["point_matches"] = random_points(
                fx, fy, valid, (roi, roi),
                npoints=cfg.npoints(im_data),
                inv_scale=1.0 / scale,
                features=features,
                debug=cfg.debug,
                point_matches=im_data.get("point_matches"),
            )

    def flush_group(tasks: List[_Task]):
        if not tasks:
            return
        t0 = tasks[0]
        params = TVL1Params.from_config(t0.im_data, args)
        output_type = cfg.output_type(t0.im_data)
        features = resolve_features(t0.im_data, args) or any(
            k == "default" for k in t0.rois
        )
        mode = _solve_mode(features, output_type)
        if (
            output_type == "random_points"
            and n_shards == 1
            and args.get("device_sample", True)
        ):
            # random_points needs nothing full-sized on the host: the
            # device-resident pipeline uploads unique frames once and
            # reads back only sampled points, a few groups behind the
            # dispatch front (engine/device_group.py). It declines (returns
            # False) for groups whose pre-align affine exceeds the
            # shift-warp residual contract — those fall through to the
            # host path, whose map composition uses the exact warp.
            if flush_group_device(tasks, params, mode, features):
                return
        n_pad = -(-len(tasks) // n_shards) * n_shards
        fh, fw = t0.frame0.shape

        affines = np.tile(
            np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (n_pad, 1, 1)
        )
        frames1 = [t.frame1 for t in tasks]
        if features:
            # one device dispatch pre-aligns + warps the whole group
            # (ref: per-pair find_alignment + warpAffine,
            # src/optflow.cpp:366-377)
            from optflow.features.align import (
                print_align_warnings,
                resolve_feature_params,
            )

            ftype, orb, surf, mp = resolve_feature_params(t0.im_data, args)
            uniq, f0_idx, f1_idx = _dedup_frames(tasks, n_pad)
            # pad the unique-frame count to a bucket (multiple of 4) so
            # find_alignment_indexed doesn't recompile for every distinct
            # dedup pattern; zero pad frames detect nothing and are never
            # indexed
            f_bucket = -(-len(uniq) // 4) * 4
            frames_np = np.zeros((f_bucket, fh, fw), np.float32)
            frames_np[: len(uniq)] = np.stack(uniq)
            prealign = _batched_prealigner(fh, fw, ftype, orb, surf, mp)
            with timer.stage("prealign"):
                frames_d = jnp.asarray(frames_np)
                f1_idx_d = jnp.asarray(f1_idx)
                (aff_d, warped_d, n_good, enough, homo_ok, homos,
                 ncl) = prealign(frames_d, f1_idx_d, jnp.asarray(f0_idx))
                warped_d = _fix_clamped_warps(
                    frames_d, f1_idx, warped_d, aff_d, np.asarray(ncl)
                )
                affines = np.asarray(aff_d)
                warped = np.asarray(warped_d)
                homos = np.asarray(homos)
            for j, t in enumerate(tasks):
                if cfg.debug:
                    print(f"Number of good features: {int(n_good[j])}")
                # debug parity with the sequential path: print the raw
                # homography under debug (src/features.cpp:137-140,150-153)
                print_align_warnings(
                    bool(enough[j]), bool(homo_ok[j]), homos[j], cfg.debug
                )
            frames1 = [warped[j] for j in range(len(tasks))]

        for roi_key in sorted(t0.rois.keys()):
            roi: Roi = t0.rois[roi_key]  # type: ignore[assignment]
            h, w = roi.shape
            f0s = np.zeros((n_pad, h, w), np.float32)
            f1s = np.zeros((n_pad, h, w), np.float32)
            for j, t in enumerate(tasks):
                f0s[j] = t.frame0[roi.slices()]
                f1s[j] = frames1[j][roi.slices()]
            solver, sharding = _get_batched_solver(h, w, params, mode, mesh)
            a, b = jnp.asarray(f0s), jnp.asarray(f1s)
            affs = jnp.asarray(affines)
            if sharding is not None:
                # P("pairs") shards dim 0 for any rank
                a = jax.device_put(a, sharding)
                b = jax.device_put(b, sharding)
                affs = jax.device_put(affs, sharding)
            with timer.stage("solve"):
                fxs, fys, valids = solver(a, b, affs)
                fxs = np.asarray(fxs)
                fys = np.asarray(fys)
                valids = np.asarray(valids)
            with timer.stage("postprocess"):
                for j, task in enumerate(tasks):
                    post_process(
                        task, roi_key, roi, fxs[j], fys[j], valids[j],
                        features,
                    )
        finish_tasks(tasks)

    def finish_tasks(tasks: List[_Task]):
        for task in tasks:
            stats["pairs"] += 1
            stats["batched"] += 1
            if cfg.output_type(task.im_data) == "random_points":
                move_pm(task.im_data, args)
                upload_state["pending"] = True
            if journal:
                journal.record_pair(pair_key(task.im_data, args))
            maybe_flush(task.index)

    dev_cache = None
    group_rng = np.random.default_rng()
    # device-path groups whose packed readbacks are still in flight:
    # deferring the (single, small) per-group sync a few groups deep
    # lets the host decode/upload group g+1 while the device solves
    # group g — without it every group pays the full serial chain
    pending_groups: List[Dict] = []
    pipeline_depth = int(args.get("device_pipeline_depth", 3))

    def drain_pending(all_groups: bool = False):
        while pending_groups and (
            all_groups or len(pending_groups) > pipeline_depth
        ):
            complete_device_group(pending_groups.pop(0))

    def flush_group_device(
        tasks: List[_Task], params, mode: str, features: bool
    ):
        from optflow.engine import device_group as dg

        nonlocal dev_cache
        if dev_cache is None:
            dev_cache = dg.DeviceFrameCache()
        t0 = tasks[0]
        fh, fw = t0.frame0.shape
        n = len(tasks)
        nb = dg._bucket(n)
        npoints = cfg.npoints(t0.im_data)

        with timer.stage("h2d"):
            uniq, f0_idx, f1_idx = _dedup_frames(tasks, nb)
            # one stacked upload for the group's cache misses, at the
            # scale-appropriate dtype (f16 only where lossless)
            handles = dev_cache.get_many(
                uniq, dg.frame_upload_dtype(cfg.scale(t0.im_data))
            )
            frames_dev, _u = dg.stack_frames(handles, fh, fw)

        aff_d = warped_d = None
        if features:
            from optflow.features.align import (
                print_align_warnings,
                resolve_feature_params,
            )

            ftype, orb, surf, mp = resolve_feature_params(t0.im_data, args)
            prealign = _batched_prealigner(fh, fw, ftype, orb, surf, mp)
            with timer.stage("prealign"):
                (aff_d, warped_d, n_good, enough, homo_ok, homos,
                 ncl) = prealign(
                    frames_dev.astype(jnp.float32),
                    jnp.asarray(f1_idx),
                    jnp.asarray(f0_idx),
                )
                enough = np.asarray(enough)
                homo_ok = np.asarray(homo_ok)
                ncl_np = np.asarray(ncl)
            if (ncl_np[:n] > 0).any():
                # out-of-contract affine: the device path's map
                # composition would clamp too — decline the whole group
                # to the host path (exact warps throughout)
                print(
                    f"batch_runner: affine beyond the shift-warp "
                    f"residual contract in a {n}-pair group; using the "
                    f"exact host path",
                    file=sys.stderr,
                )
                return False
            for j in range(n):
                if cfg.debug:
                    print(f"Number of good features: {int(n_good[j])}")
                print_align_warnings(
                    bool(enough[j]), bool(homo_ok[j]),
                    np.asarray(homos[j]), cfg.debug,
                )

        # same-shape ROIs solve together (top/bottom strips share one
        # program and one readback); shapes differ -> separate passes
        by_shape: Dict[Tuple[int, int], List[Tuple[str, Roi]]] = {}
        for roi_key in sorted(t0.rois.keys()):
            roi: Roi = t0.rois[roi_key]  # type: ignore[assignment]
            by_shape.setdefault(roi.shape, []).append((roi_key, roi))

        payloads = []
        for shape, roi_list in by_shape.items():
            seed = int(group_rng.integers(1, 2 ** 31))
            with timer.stage("solve"):
                packed = dg.solve_group_on_device(
                    frames_dev, f0_idx, f1_idx, roi_list, params, mode,
                    npoints, affines_dev=aff_d, warped_dev=warped_d,
                    debug=cfg.debug, seed=seed,
                )
            payloads.append({"roi_list": roi_list, "packed": packed})
        pending_groups.append({
            "tasks": tasks, "payloads": payloads, "features": features,
            "nb": nb, "npoints": npoints,
        })
        drain_pending()
        return True

    def complete_device_group(ent: Dict):
        from optflow.engine import device_group as dg

        tasks = ent["tasks"]
        nb = ent["nb"]
        npoints = ent["npoints"]
        features = ent["features"]
        for pl in ent["payloads"]:
            roi_list = pl["roi_list"]
            with timer.stage("sample"):
                packed_np = np.asarray(pl["packed"])  # the one sync
            samples, counts = dg.unpack_samples(packed_np, nb, npoints)
            with timer.stage("postprocess"):
                for r, (_roi_key, roi) in enumerate(roi_list):
                    for j, task in enumerate(tasks):
                        task.im_data["point_matches"] = (
                            dg.matches_from_samples(
                                samples[r, j], int(counts[r, j]), roi,
                                1.0 / cfg.scale(task.im_data), features,
                                task.im_data.get("point_matches"),
                            )
                        )
        finish_tasks(tasks)

    groups: Dict[Tuple, List[_Task]] = {}

    for i, im_data in enumerate(cfg.images):
        p = str(im_data["p"])
        q = str(im_data["q"])
        scale = cfg.scale(im_data)
        im_data["scale"] = scale
        if journal and any(
            k in completed for k in pair_key_aliases(im_data, args)
        ):
            stats["resumed"] += 1
            continue
        print(f"{p} {q}")
        try:
            with timer.stage("decode"):
                frame0, frame1 = cache.get_pair(p, q, scale)
        except ImageReadError as e:
            print(f"Error: {e.args[0]} ", file=sys.stderr)
            stats["skipped"] += 1
            continue
        rows = min(frame0.shape[0], frame1.shape[0])
        cols = min(frame0.shape[1], frame1.shape[1])
        rois = resolve_rois(im_data, args, rows, cols)
        im_data["output"] = cfg.output_path(im_data)

        if _batchable(im_data, args, frame0, frame1, rois, can_batch_features):
            key = _group_key(im_data, args, frame0, frame1, rois, cfg)
            groups.setdefault(key, []).append(
                _Task(i, im_data, frame0, frame1, rois)
            )
            if len(groups[key]) >= pair_batch:
                flush_group(groups.pop(key))
        else:
            with timer.stage("solve"):
                solve_rois(
                    frame0, frame1, rois, im_data, args,
                    aligner=aligner, write_outputs=write_outputs,
                )
            stats["pairs"] += 1
            stats["sequential"] += 1
            if cfg.output_type(im_data) == "random_points":
                move_pm(im_data, args)
                upload_state["pending"] = True
            if journal:
                journal.record_pair(pair_key(im_data, args))
            maybe_flush(i)

    for tasks in groups.values():
        flush_group(tasks)
    drain_pending(all_groups=True)
    maybe_flush(len(cfg.images), force=True)

    if prefetch is not None:
        prefetch.close()
    if journal:
        journal.close()
    stats["timing"] = timer.summary(stats["pairs"])
    return stats
