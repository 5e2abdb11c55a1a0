"""Prefetching frame loader: overlap host decode with device compute.

The reference's pair loop decodes synchronously between GPU solves
(src/optflow.cpp:106-125); its only overlap is the LRU-of-2 frame swap.
Here the job's full image schedule is known up front, so the native
threaded loader (optflow/native) decodes ``lookahead`` upcoming frames
in the background while the device works on the current pair.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from optflow.core.imgio import ImageReadError, read_gray_scaled


class PrefetchLoader:
    """Callable loader for runner.FrameCache with background lookahead
    and a decoded-frame LRU.

    The LRU matters because the production pair graph reuses every frame
    in up to 2 * MAX_DZ = 6 pairs spread over ~4 * MAX_DZ consecutive
    pairs (gen_cross_file_list.py z-distance <= 3) while the engine's
    FrameCache holds only the current pair — without it every section
    is DECODED ~5x and every
    re-decode is a NEW ndarray, which also defeats the identity-keyed
    detect/describe dedup and device-upload caches. Returning the same
    array object for a cached (path, scale) restores both."""

    def __init__(
        self,
        schedule: List[Tuple[str, float]],
        lookahead: int = 8,
        n_threads: int = 4,
        cache_frames: int = 32,
    ):
        from optflow.native import NativeLoader

        self._native = NativeLoader(n_threads)
        # de-duplicated schedule in first-use order
        seen = set()
        self._schedule: List[Tuple[str, float]] = []
        for key in schedule:
            if key not in seen:
                seen.add(key)
                self._schedule.append(key)
        self._pos = 0
        self._lookahead = lookahead
        self._pending: Dict[Tuple[str, float], int] = {}
        self._cache: Dict[Tuple[str, float], np.ndarray] = {}
        self._cache_cap = cache_frames
        self._fill()

    def _fill(self):
        while (
            len(self._pending) < self._lookahead
            and self._pos < len(self._schedule)
        ):
            key = self._schedule[self._pos]
            self._pos += 1
            if key not in self._pending:
                self._pending[key] = self._native.submit(key[0], key[1])

    def _insert(self, key, frame: np.ndarray) -> np.ndarray:
        self._cache[key] = frame
        while len(self._cache) > self._cache_cap:
            self._cache.pop(next(iter(self._cache)))
        return frame

    def __call__(self, path: str, scale: float) -> np.ndarray:
        key = (path, scale)
        hit = self._cache.get(key)
        if hit is not None:
            # refresh LRU position
            self._cache.pop(key)
            self._cache[key] = hit
            return hit
        job_id = self._pending.pop(key, None)
        if job_id is None:
            job_id = self._native.submit(path, scale)
        try:
            return self._insert(key, self._native.wait(job_id))
        except ImageReadError:
            # The native decoder covers PNG/JPEG/TIFF; anything it can't
            # parse falls back to the Python decoder (cv2/PIL) so a format
            # gap never silently skips a pair — the reference's cv::imread
            # (src/optflow.cpp:106) accepts whatever OpenCV was built with.
            return self._insert(key, read_gray_scaled(path, scale))
        finally:
            self._fill()

    def close(self):
        # drain outstanding jobs so worker threads quiesce
        for job_id in self._pending.values():
            try:
                self._native.wait(job_id)
            except Exception:
                pass
        self._pending.clear()
        self._native.close()


def make_prefetch_loader(args: dict) -> Optional[PrefetchLoader]:
    """Build a prefetch loader for a job dict when the native library is
    available; None otherwise (callers fall back to the Python loader)."""
    try:
        from optflow.native import available
    except ImportError:  # pragma: no cover
        return None
    if not available():
        return None
    from optflow.core.config import JobConfig

    cfg = JobConfig(args)
    schedule: List[Tuple[str, float]] = []
    for im in cfg.images:
        scale = cfg.scale(im)
        schedule.append((str(im.get("p", "")), scale))
        schedule.append((str(im.get("q", "")), scale))
    if not schedule:
        return None
    # lookahead sized so decode stays ahead of a whole dispatch-
    # pipelined batch group (the r5 device path keeps ~3 groups in
    # flight); overridable per job
    return PrefetchLoader(
        schedule,
        lookahead=int(args.get("prefetch_lookahead", 48)),
        n_threads=int(args.get("prefetch_threads", 8)),
        cache_frames=int(args.get("prefetch_cache_frames", 32)),
    )
