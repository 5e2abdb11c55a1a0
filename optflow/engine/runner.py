"""Job runner: the pair loop with frame caching and batched match upload.

Reimplements ``from_file`` (src/optflow.cpp:75-178):

- iterates ``args["images"]``
- per-pair scale resolution (per-image overrides global, default 0.5)
- frame-reuse cache: if the new p is the old q at the same scale the
  decoded/scaled frames are swapped instead of reloaded; unchanged names
  skip the reload; the old p can serve as the new q
  (src/optflow.cpp:97-131)
- unreadable image -> log + skip pair (src/optflow.cpp:108-124; the
  reference prints frame0's name even for frame1 failures — fixed here)
- ROI resolution, output-path composition ``output_dir/name_<scale %.2f>``
- for random_points output: flush accumulated matches to the sink every
  ``batch_size`` (default 100) pairs and once at the end
  (src/optflow.cpp:160-175)
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np

from optflow.core.config import JobConfig, cfg_get
from optflow.core.imgio import ImageReadError, read_gray, resize_scale
from optflow.engine.pair import Aligner, solve_rois
from optflow.engine.rois import resolve_rois
from optflow.engine.sampler import move_pm
from optflow.sinks.http import make_sink
from optflow.sinks.store import MatchSink


class FrameCache:
    """The reference's LRU-of-2 decoded-frame cache (src/optflow.cpp:97-131),
    generalized to key on (path, scale)."""

    def __init__(self, loader=None):
        self._loader = loader or (
            lambda path, scale: resize_scale(read_gray(path), scale).astype(
                np.float32
            )
        )
        self._frames: Dict[tuple, np.ndarray] = {}

    def get_pair(self, p: str, q: str, scale: float):
        kp, kq = (p, scale), (q, scale)
        new: Dict[tuple, np.ndarray] = {}
        for key in (kp, kq):
            if key in new:
                continue
            if key in self._frames:
                new[key] = self._frames[key]
            else:
                new[key] = self._loader(*key)
        self._frames = new
        return new[kp], new[kq]


def run_job(
    args: Dict,
    *,
    aligner: Optional[Aligner] = None,
    sink: Optional[MatchSink] = None,
    loader=None,
    write_outputs: bool = True,
) -> Dict:
    """Execute a loaded job dict. Returns stats."""
    from optflow.engine.journal import JobJournal, pair_key, pair_key_aliases
    from optflow.utils.metrics import StageTimer

    cfg = JobConfig(args)
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

    last_upload = 0
    any_upload_since = False
    batch_size = cfg.batch_size()
    stats = {"pairs": 0, "skipped": 0, "uploads": 0, "matches": 0,
             "resumed": 0}

    def flush():
        batch = args.get("point_matches", [])
        stats["matches"] += sum(
            len(m["matches"].get("w", [])) for m in batch
        )
        with timer.stage("sink"):
            sink.put(batch)
        args["point_matches"] = []
        stats["uploads"] += 1
        if journal:
            journal.record_flush()

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
        with timer.stage("solve"):
            solve_rois(
                frame0,
                frame1,
                rois,
                im_data,
                args,
                aligner=aligner,
                write_outputs=write_outputs,
            )
        stats["pairs"] += 1

        if cfg.output_type(im_data) == "random_points":
            move_pm(im_data, args)
            any_upload_since = True
        if journal:
            journal.record_pair(pair_key(im_data, args))
        if cfg.output_type(im_data) == "random_points":
            if i > last_upload + batch_size:
                flush()
                last_upload = i
                any_upload_since = False

    if any_upload_since:
        flush()

    if prefetch is not None:
        prefetch.close()
    if journal:
        journal.close()

    stats["timing"] = timer.summary(stats["pairs"])
    return stats
