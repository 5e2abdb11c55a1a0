"""Resume-journal tests: crash-recovery skip semantics for both output
types, and the runner's timing stats."""

import numpy as np
import pytest

from optflow.engine.journal import JobJournal, pair_key
from optflow.engine.runner import run_job
from optflow.sinks.store import JsonlMatchSink
from tests.conftest import make_fibsem_like

FAST_TV = {"nscales": 2, "warps": 2, "iterations": 25}


def test_journal_map_semantics(tmp_path):
    j = JobJournal(str(tmp_path / "j.jsonl"))
    j.record_pair("a|b|x")
    j.record_pair("c|d|y")
    j.close()
    j2 = JobJournal(str(tmp_path / "j.jsonl"))
    assert j2.completed_keys("map") == {"a|b|x", "c|d|y"}
    j2.close()


def test_journal_random_points_needs_flush(tmp_path):
    j = JobJournal(str(tmp_path / "j.jsonl"))
    j.record_pair("a|b|x")
    j.record_flush()
    j.record_pair("c|d|y")  # solved but never flushed
    j.close()
    j2 = JobJournal(str(tmp_path / "j.jsonl"))
    assert j2.completed_keys("random_points") == {"a|b|x"}
    assert j2.completed_keys("map") == {"a|b|x", "c|d|y"}
    j2.close()


def test_pair_key():
    assert pair_key({"p": "a", "q": "b", "output_name": "n"}) == "a|b|n"
    assert pair_key({"p": "a", "q": "b"}) == "a|b|"


def _make_job(tmp_path, rng, n_pairs=3):
    from PIL import Image

    ims = [make_fibsem_like(rng, 32, 48) for _ in range(n_pairs + 1)]
    paths = []
    for i, im in enumerate(ims):
        p = tmp_path / f"f{i}.png"
        Image.fromarray(im.astype(np.uint8)).save(str(p))
        paths.append(str(p))
    return {
        "style": 1,
        "scale": 1.0,
        "output_type": "flow",
        "output_dir": str(tmp_path),
        "rois": {"top": 16},
        "journal": str(tmp_path / "journal.jsonl"),
        "images": [
            {"p": paths[i], "q": paths[i + 1], "output_name": f"n{i}"}
            for i in range(n_pairs)
        ],
        **FAST_TV,
    }


def test_run_job_resume_skips_completed(tmp_path, rng):
    job = _make_job(tmp_path, rng)
    stats1 = run_job(dict(job))
    assert stats1["pairs"] == 3 and stats1["resumed"] == 0
    # rerun: everything journaled -> all skipped
    stats2 = run_job(dict(job))
    assert stats2["pairs"] == 0 and stats2["resumed"] == 3


def test_run_job_partial_resume(tmp_path, rng):
    job = _make_job(tmp_path, rng)
    # simulate a crash after one pair: pre-populate the journal
    j = JobJournal(job["journal"])
    j.record_pair(pair_key(job["images"][0], job))
    j.close()
    stats = run_job(dict(job))
    assert stats["resumed"] == 1
    assert stats["pairs"] == 2


def test_run_job_timing_stats(tmp_path, rng):
    job = _make_job(tmp_path, rng, n_pairs=1)
    del job["journal"]
    stats = run_job(job)
    t = stats["timing"]
    assert t["decode_s"] >= 0 and t["solve_s"] > 0
    assert t["pairs_per_s"] > 0


def test_legacy_journal_keys_resume_under_default_params(tmp_path, rng):
    """Journals written before the params/scale signature recorded bare
    p|q|output_name keys. An upgrade must not re-solve a default-params
    job (ADVICE r2) — the legacy key is accepted as an alias iff the
    effective params ARE the historical defaults."""
    from optflow.engine.journal import pair_key_aliases

    im = {"p": "a", "q": "b", "output_name": "n"}
    # default params + default scale -> legacy alias accepted
    assert pair_key_aliases(im, {"scale": 0.5}) == (
        pair_key(im, {"scale": 0.5}),
        "a|b|n",
    )
    # non-default params -> no alias, legacy entries re-solve
    assert pair_key_aliases(im, {"iterations": 100}) == (
        pair_key(im, {"iterations": 100}),
    )
    assert pair_key_aliases(im, {"scale": 0.25}) == (
        pair_key(im, {"scale": 0.25}),
    )

    # end-to-end: a legacy journal (bare keys) fully resumes a job whose
    # params are the defaults-with-explicit-default-values
    job = _make_job(tmp_path, rng)
    for k in ("nscales", "warps", "iterations"):
        del job[k]
    job["scale"] = 0.5
    j = JobJournal(job["journal"])
    for im_data in job["images"]:
        j.record_pair(pair_key(im_data))  # legacy bare key
    j.close()
    stats = run_job(dict(job))
    assert stats["pairs"] == 0 and stats["resumed"] == 3


def test_pair_key_invalidated_by_params_and_scale():
    """Changing solver params or scale must change the journal key, so a
    rerun with different settings re-solves instead of silently skipping."""
    im = {"p": "a", "q": "b", "output_name": "n"}
    k1 = pair_key(im, {"scale": 0.5})
    k2 = pair_key(im, {"scale": 0.25})
    k3 = pair_key(im, {"scale": 0.5, "iterations": 100})
    k4 = pair_key(im, {"scale": 0.5})
    assert k1 == k4
    assert len({k1, k2, k3}) == 3
    assert k1.startswith("a|b|n|")
