"""Batched runner tests: output parity with the sequential runner, fallback
paths, journal integration, and upload semantics."""

import numpy as np
import pytest

from optflow.core.imgio import read_float_tiff
from optflow.engine.batch_runner import run_job_batched
from optflow.engine.runner import run_job
from optflow.sinks.store import JsonlMatchSink
from tests.conftest import make_fibsem_like

FAST_TV = {"nscales": 2, "warps": 2, "iterations": 25}


def _write_pairs(tmp_path, rng, n_pairs=5, h=32, w=48):
    import scipy.ndimage as ndi
    from PIL import Image

    paths = []
    for i in range(n_pairs + 1):
        im = make_fibsem_like(rng, h, w)
        p = tmp_path / f"f{i}.png"
        Image.fromarray(im.astype(np.uint8)).save(str(p))
        paths.append(str(p))
    return paths


def _job(tmp_path, paths, outdir, **kw):
    job = {
        "style": 1,
        "scale": 1.0,
        "output_type": "flow",
        "output_dir": str(outdir),
        "rois": {"top": 16},
        "images": [
            {"p": paths[i], "q": paths[i + 1], "pId": f"t{i}",
             "qId": f"t{i+1}", "pGroupId": f"{i}.0",
             "qGroupId": f"{i+1}.0", "output_name": f"n{i}"}
            for i in range(len(paths) - 1)
        ],
        **FAST_TV,
    }
    job.update(kw)
    return job


def test_batched_matches_sequential_tiffs(tmp_path, rng):
    paths = _write_pairs(tmp_path, rng)
    d_seq = tmp_path / "seq"
    d_bat = tmp_path / "bat"
    d_seq.mkdir()
    d_bat.mkdir()
    s1 = run_job(_job(tmp_path, paths, d_seq))
    s2 = run_job_batched(_job(tmp_path, paths, d_bat), pair_batch=3)
    assert s1["pairs"] == s2["pairs"] == 5
    assert s2["batched"] == 5 and s2["sequential"] == 0
    for i in range(5):
        a = read_float_tiff(str(d_seq / f"n{i}_1.00_top_x.tiff"))
        b = read_float_tiff(str(d_bat / f"n{i}_1.00_top_x.tiff"))
        assert np.allclose(a, b, atol=1e-4), f"pair {i} diverged"


def test_batched_random_points_sink(tmp_path, rng):
    paths = _write_pairs(tmp_path, rng, n_pairs=4)
    out = tmp_path / "m.jsonl"
    job = _job(
        tmp_path, paths, tmp_path,
        output_type="random_points", npoints=6,
        match_sink="jsonl", match_output=str(out), debug=True,
    )
    stats = run_job_batched(job, pair_batch=2)
    assert stats["pairs"] == 4
    recs = JsonlMatchSink(str(out)).read_all()
    assert len(recs) == 4
    ids = {r["pId"] for r in recs}
    assert ids == {"t0", "t1", "t2", "t3"}
    for r in recs:
        assert len(r["matches"]["w"]) == 6


def test_batched_features_pairs_batch(tmp_path, rng):
    """Features-enabled pairs run through the batched path (device
    pre-alignment), matching the sequential path with the default aligner.
    Production job generation enables features near column boundaries
    (ref: gen_cross_file_list.py:33-41), so this is the production-relevant
    batch shape."""
    from optflow.engine.features_glue import default_aligner

    paths = _write_pairs(tmp_path, rng, n_pairs=2)
    d_bat = tmp_path / "bat"
    d_seq = tmp_path / "seq"
    d_bat.mkdir()
    d_seq.mkdir()
    job_b = _job(tmp_path, paths, d_bat, features=2)
    stats = run_job_batched(job_b, pair_batch=4)
    assert stats["batched"] == 2 and stats["sequential"] == 0

    from optflow.engine.runner import run_job

    job_s = _job(tmp_path, paths, d_seq, features=2)
    run_job(job_s, aligner=default_aligner)
    for i in range(2):
        a = read_float_tiff(str(d_bat / f"n{i}_1.00_top_x.tiff"))
        b = read_float_tiff(str(d_seq / f"n{i}_1.00_top_x.tiff"))
        assert np.allclose(a, b, atol=1e-3), f"features pair {i} diverged"


def test_batched_custom_aligner_forces_sequential(tmp_path, rng):
    """A caller-supplied host aligner can't run inside the batch; features
    pairs fall back to the sequential path where it is honored."""
    calls = []

    def my_aligner(f1, f0, im_args, args):
        calls.append(1)
        return np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32)

    paths = _write_pairs(tmp_path, rng, n_pairs=2)
    job = _job(tmp_path, paths, tmp_path, features=2)
    stats = run_job_batched(job, pair_batch=4, aligner=my_aligner)
    assert stats["sequential"] == 2 and stats["batched"] == 0
    assert len(calls) == 2


def test_batched_mixed_params_group_separately(tmp_path, rng):
    paths = _write_pairs(tmp_path, rng, n_pairs=4)
    job = _job(tmp_path, paths, tmp_path)
    job["images"][0]["iterations"] = 10  # different params -> own group
    stats = run_job_batched(job, pair_batch=10)
    assert stats["pairs"] == 4
    assert stats["batched"] == 4


def test_batched_journal_resume(tmp_path, rng):
    paths = _write_pairs(tmp_path, rng, n_pairs=3)
    job = _job(tmp_path, paths, tmp_path,
               journal=str(tmp_path / "j.jsonl"))
    s1 = run_job_batched(dict(job), pair_batch=2)
    assert s1["pairs"] == 3
    s2 = run_job_batched(dict(job), pair_batch=2)
    assert s2["resumed"] == 3 and s2["pairs"] == 0


def test_batched_skips_bad_images(tmp_path, rng):
    paths = _write_pairs(tmp_path, rng, n_pairs=2)
    job = _job(tmp_path, paths, tmp_path)
    job["images"][0]["p"] = str(tmp_path / "missing.png")
    stats = run_job_batched(job, pair_batch=2)
    assert stats["skipped"] == 1 and stats["pairs"] == 1


def test_device_sample_path_matches_host_sampling(tmp_path, rng):
    """The device-resident random_points pipeline (single-device groups:
    frames uploaded once as f16, ROI slice + solve + post + top-k
    sampling on device, one packed readback — r5) must produce the same
    match STRUCTURE as the host path (counts, weights, p on the sampled
    grid, q = p + flow at the sample) and displacements consistent with
    the synthetic truth."""
    from PIL import Image

    from optflow.dist.mesh import make_pair_mesh
    from tests.test_tvl1 import translate

    # chained TRANSLATED stack: flow between consecutive frames is the
    # known (dx, dy), so both samplers' mean displacements are anchored
    dx, dy = 1.1, -0.7
    base = make_fibsem_like(rng, 48, 48)
    paths = []
    for i in range(5):
        im = translate(base, dx * i, dy * i)
        p = tmp_path / f"f{i}.png"
        Image.fromarray(np.clip(im, 0, 255).astype(np.uint8)).save(str(p))
        paths.append(str(p))
    sink_dev = JsonlMatchSink(str(tmp_path / "dev.jsonl"))
    sink_host = JsonlMatchSink(str(tmp_path / "host.jsonl"))
    mesh1 = make_pair_mesh(n_pairs_axis=1, n_rows_axis=1)

    def job(**kw):
        return _job(
            tmp_path, paths, tmp_path, output_type="random_points",
            npoints=5, rois={"top": 16, "bottom": 16}, debug=True,
            prefetch=False, **kw,
        )

    s_dev = run_job_batched(job(), sink=sink_dev, mesh=mesh1)
    s_host = run_job_batched(
        job(device_sample=False), sink=sink_host, mesh=mesh1
    )
    assert s_dev["pairs"] == s_host["pairs"] == 4
    assert s_dev["batched"] == 4

    import json

    recs_dev = [json.loads(l) for l in
                open(tmp_path / "dev.jsonl").read().splitlines()]
    recs_host = [json.loads(l) for l in
                 open(tmp_path / "host.jsonl").read().splitlines()]
    assert len(recs_dev) == len(recs_host) == 4
    for rd, rh in zip(recs_dev, recs_host):
        assert rd["pId"] == rh["pId"] and rd["qId"] == rh["qId"]
        md, mh = rd["matches"], rh["matches"]
        # 5 points per ROI x 2 ROIs, weight 1 (full-intensity fixtures)
        assert len(md["w"]) == len(mh["w"]) == 10
        assert set(md["w"]) == {1}
        # identical flow field, different (seeded) sample positions:
        # both samplers' mean displacements sit on the known shift
        dd = np.asarray(md["q"]) - np.asarray(md["p"])
        dh = np.asarray(mh["q"]) - np.asarray(mh["p"])
        for d in (dd, dh):
            assert np.allclose(
                d.mean(axis=1), [dx, dy], atol=0.4
            ), d.mean(axis=1)


def test_job_with_retired_repair_margin_key_still_runs(tmp_path, rng):
    """Job files written for the removed shift-warp repair ladder carry
    ``repair_margin``; they still load and solve (the key is ignored)."""
    from optflow.dist.mesh import make_pair_mesh

    paths = _write_pairs(tmp_path, rng, n_pairs=2)
    job = _job(tmp_path, paths, tmp_path, output_type="random_points",
               npoints=3, repair_margin=0.25, prefetch=False)
    stats = run_job_batched(
        job, sink=JsonlMatchSink(str(tmp_path / "m.jsonl")),
        mesh=make_pair_mesh(n_pairs_axis=1, n_rows_axis=1),
    )
    assert stats["pairs"] == stats["batched"] == 2
    assert stats["matches"] == 2 * 3


def test_device_sample_dummy_match_on_empty_mask(tmp_path, rng):
    """A pair whose frames are entirely background (<= 1.0 intensity)
    must emit the reference's dummy (-1,-1)->(-1,-1) w=0 match through
    the device sampler too (src/optflow.cpp:560-569)."""
    from PIL import Image

    from optflow.dist.mesh import make_pair_mesh

    p0 = tmp_path / "z0.png"
    p1 = tmp_path / "z1.png"
    Image.fromarray(np.zeros((32, 48), np.uint8)).save(str(p0))
    Image.fromarray(np.zeros((32, 48), np.uint8)).save(str(p1))
    job = {
        "style": 1, "scale": 1.0, "output_type": "random_points",
        "npoints": 4, "rois": {"top": 16}, "prefetch": False,
        "images": [{"p": str(p0), "q": str(p1), "pId": "a", "qId": "b",
                    "pGroupId": "0.0", "qGroupId": "1.0",
                    "output_name": "z"}],
        **FAST_TV,
    }
    sink = JsonlMatchSink(str(tmp_path / "m.jsonl"))
    mesh1 = make_pair_mesh(n_pairs_axis=1, n_rows_axis=1)
    stats = run_job_batched(job, sink=sink, mesh=mesh1)
    assert stats["pairs"] == 1

    import json

    rec = json.loads(open(tmp_path / "m.jsonl").read().splitlines()[0])
    m = rec["matches"]
    assert m["w"] == [0]
    assert m["p"] == [[-1], [-1]] and m["q"] == [[-1], [-1]]


def test_device_path_declines_out_of_contract_affine(tmp_path, rng,
                                                     monkeypatch):
    """A features group whose pre-align affine exceeds the shift-warp
    residual contract must fall through to the exact host path instead
    of sampling clamped maps (code-review r5 #1)."""
    import jax
    import jax.numpy as jnp

    import optflow.engine.batch_runner as br
    from optflow.dist.mesh import make_pair_mesh

    paths = _write_pairs(tmp_path, rng, n_pairs=2, h=48, w=48)

    real = br._batched_prealigner.__wrapped__

    def fake(h, w, ftype, orb, surf, mp):
        inner = real(h, w, ftype, orb, surf, mp)

        def f(frames, f1_idx, f0_idx):
            out = list(inner(frames, f1_idx, f0_idx))
            out[-1] = jnp.ones_like(out[-1])  # every image "clamped"
            return tuple(out)

        return f

    monkeypatch.setattr(br, "_batched_prealigner", fake)

    sink = JsonlMatchSink(str(tmp_path / "m.jsonl"))
    mesh1 = make_pair_mesh(n_pairs_axis=1, n_rows_axis=1)
    job = _job(
        tmp_path, paths, tmp_path, output_type="random_points",
        npoints=4, rois={"top": 16}, features=2, prefetch=False,
    )
    stats = run_job_batched(job, sink=sink, mesh=mesh1)
    assert stats["pairs"] == 2 and stats["batched"] == 2
    # declined groups never reach the device sampler
    assert "sample_s" not in stats["timing"], stats["timing"]

    import json

    recs = [json.loads(l) for l in
            open(tmp_path / "m.jsonl").read().splitlines()]
    assert len(recs) == 2
    for r in recs:
        assert len(r["matches"]["w"]) == 4
