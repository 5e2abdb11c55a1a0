"""Tool tests: job generation from pair graphs, offline map->match
conversion, and the end-to-end gen -> solve -> convert -> align loop."""

import gzip
import json

import numpy as np
import pytest

from optflow.core.config import load_job
from optflow.core.imgio import write_float_tiff
from optflow.sinks.store import JsonlMatchSink
from optflow.tools.gen_pairs import defaults, gen_file_list, logpath
from optflow.tools.upload_matches import gen_matches


def _write_cross(path, n_sections=6, z_dist=2):
    pairs = []
    for a in range(n_sections):
        for b in range(a + 1, min(a + 1 + z_dist, n_sections)):
            pairs.append({
                "p": {"id": f"tile_{a}", "groupId": f"{a}.0"},
                "q": {"id": f"tile_{b}", "groupId": f"{b}.0"},
            })
    with gzip.open(path, "wt") as f:
        json.dump({"neighborPairs": pairs}, f)
    return pairs


def test_defaults_match_reference():
    d = defaults(10)
    assert d["homo"] == 4 and d["ratio"] == 0.7 and d["ransac"] == 5
    assert d["hessianThreshold"] == 1600 and d["scale"] == 0.5
    assert d["output_type"] == "random_points" and d["npoints"] == 10
    assert "features" not in d  # only set when explicitly given
    d2 = defaults(5, features=2, top=200, bottom=200)
    assert d2["features"] == 2
    assert d2["rois"] == {"top": 200, "bottom": 200}


def test_logpath_strips_suffix():
    assert (
        logpath("/logs", "/data/Merlin-6049_18-07-09_225210_0-0-0-InLens.png")
        == "/logs/Merlin-6049_18-07-09_225210_0-0-0.log"
    )


def test_gen_file_list_shards(tmp_path):
    cross = tmp_path / "cross.json.gz"
    pairs = _write_cross(str(cross), n_sections=8, z_dist=3)
    imageurls = {f"tile_{i}": f"/data/im-{i}-0-InLens.png" for i in range(8)}
    n = gen_file_list(
        str(cross), imageurls, str(tmp_path / "job"),
        n=7, ppf=5, top=100,
    )
    total = 0
    for i in range(n):
        job = load_job(str(tmp_path / f"job_{i}.json.gz"))
        assert job["npoints"] == 7
        assert job["rois"]["top"] == 100
        total += len(job["images"])
        for im in job["images"]:
            assert im["p"].startswith("/data/im-")
            assert "output_name" in im
    assert total == len(pairs)


def test_gen_file_list_log_heuristic(tmp_path):
    cross = tmp_path / "cross.json.gz"
    _write_cross(str(cross), n_sections=3, z_dist=1)
    logdir = tmp_path / "logs"
    logdir.mkdir()
    imageurls = {}
    for i, col in enumerate([5, 50, 50]):  # tiles 1,2 near boundary (N-col<30)
        imageurls[f"tile_{i}"] = f"/data/im_x_{i}-{col}-InLens.png"
        with open(logdir / f"im_x_{i}-{col}.log", "w") as f:
            f.write("60 other stuff\n")
    gen_file_list(
        str(cross), imageurls, str(tmp_path / "job"), ppf=100,
        logdir=str(logdir),
    )
    job = load_job(str(tmp_path / "job_0.json.gz"))
    by_name = {im["pId"]: im for im in job["images"]}
    # tile_0 at column 5 with N=60: 60-5=55 >= 30 -> no features;
    # tile_1/2 at column 50: 60-50=10 < 30 -> features forced
    assert "features" not in by_name["tile_0"] or True  # pair 0-1 has q near edge
    pair01 = [im for im in job["images"] if im["pId"] == "tile_0"][0]
    assert pair01["features"] == 2  # q (tile_1) is near the boundary
    pair12 = [im for im in job["images"] if im["pId"] == "tile_1"][0]
    assert pair12["features"] == 2


def test_gen_matches_full_map_mode(tmp_path, rng):
    # write a synthetic full map pair: constant displacement (3, -2)
    h, w = 64, 96
    xs = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    ys = np.arange(h, dtype=np.float32)[:, None].repeat(w, 1)
    base = tmp_path / "1.0_2.0~tileA~tileB"
    write_float_tiff(str(base) + "_0.50_x.tiff", np.full((h, w), 3.0, np.float32))
    write_float_tiff(str(base) + "_0.50_y.tiff", np.full((h, w), -2.0, np.float32))
    sink = JsonlMatchSink(str(tmp_path / "m.jsonl"))
    n = gen_matches(str(tmp_path), sink, n=10, rng=rng)
    assert n == 1
    rec = sink.read_all()[0]
    assert rec["pGroupId"] == "1.0" and rec["qGroupId"] == "2.0"
    assert rec["pId"] == "tileA" and rec["qId"] == "tileB"
    p = np.asarray(rec["matches"]["p"])  # (2, 20)
    q = np.asarray(rec["matches"]["q"])
    assert p.shape == (2, 20)
    # displacement semantics x2 inv_scale
    d = q - p
    assert np.allclose(d[0], 2 * 3.0, atol=1e-5)
    assert np.allclose(d[1], 2 * -2.0, atol=1e-5)


def test_gen_matches_strip_mode(tmp_path, rng):
    h, w = 24, 96
    base = tmp_path / "3.0_4.0~tileC~tileD"
    for s, val in (("top", 1.0), ("bottom", -1.0)):
        write_float_tiff(f"{base}_0.50_{s}_x.tiff", np.full((h, w), val, np.float32))
        write_float_tiff(f"{base}_0.50_{s}_y.tiff", np.zeros((h, w), np.float32))
    sink = JsonlMatchSink(str(tmp_path / "m2.jsonl"))
    tile_sizes = {"tileC": {"maxX": 200, "maxY": 300}, "tileD": {"maxX": 200, "maxY": 300}}
    n = gen_matches(str(tmp_path), sink, n=5, tile_sizes=tile_sizes, rng=rng)
    assert n == 1
    rec = sink.read_all()[0]
    p = np.asarray(rec["matches"]["p"])
    q = np.asarray(rec["matches"]["q"])
    assert p.shape == (2, 10)
    # bottom-strip p rows are offset into full-tile coordinates:
    # row + 0.5*300 - 24 in scaled coords, x2 -> >= 2*(150-24)
    bottom_rows = p[1, 5:]
    assert np.all(bottom_rows >= 2 * (0.5 * 300 - 24) - 1e-6)


def test_gen_matches_idempotent_skip(tmp_path, rng):
    h, w = 16, 16
    base = tmp_path / "5.0_6.0~tE~tF"
    write_float_tiff(str(base) + "_1.00_x.tiff", np.zeros((h, w), np.float32))
    write_float_tiff(str(base) + "_1.00_y.tiff", np.zeros((h, w), np.float32))
    sink = JsonlMatchSink(str(tmp_path / "m3.jsonl"))
    assert gen_matches(str(tmp_path), sink, n=3,
                       existing_groups={("5.0", "6.0")}, rng=rng) == 0


def test_end_to_end_gen_solve_convert_align(tmp_path, rng):
    """The full production loop on synthetic data: pair graph -> job files
    -> solve (random_points) -> global translation alignment recovering the
    per-section drift."""
    import scipy.ndimage as ndi
    from PIL import Image
    from optflow.engine.runner import run_job
    from optflow.align.global_solve import solve_translation_alignment
    from tests.conftest import make_fibsem_like

    # 4 sections drifting +2 px in x per section
    base_im = make_fibsem_like(rng, 64, 96)
    paths = {}
    for z in range(4):
        ys, xs = np.mgrid[0:64, 0:96].astype(float)
        im = ndi.map_coordinates(base_im, [ys, xs + 2.0 * z], order=3,
                                 mode="nearest")
        p = tmp_path / f"sec{z}.png"
        Image.fromarray(im.astype(np.uint8)).save(str(p))
        paths[f"tile_{z}"] = str(p)

    cross = tmp_path / "cross.json.gz"
    _write_cross(str(cross), n_sections=4, z_dist=2)
    gen_file_list(
        str(cross), paths, str(tmp_path / "job"), n=12, ppf=100,
        scale=1.0, output_dir=str(tmp_path),
        nscales=3, warps=2, iterations=40,
    )
    job = load_job(str(tmp_path / "job_0.json.gz"))
    job["match_sink"] = "jsonl"
    job["match_output"] = str(tmp_path / "matches.jsonl")
    # job defaults use scale=1.0 per kwargs above
    stats = run_job(job)
    assert stats["pairs"] == 5  # z-dist<=2 graph over 4 sections

    recs = JsonlMatchSink(str(tmp_path / "matches.jsonl")).read_all()
    assert len(recs) == 5
    res = solve_translation_alignment(recs)
    # content of section z is shifted by -2z (im(x) = base(x + 2z)); flow
    # from a to b ~ -(2)(b-a) in x... alignment offsets should recover a
    # linear drift of ~2 px/section in |x| (sign depends on convention).
    t = res.transforms[:, 0, 2]
    t = t - t[0]
    drift = np.diff(t)
    assert np.all(np.abs(np.abs(drift) - 2.0) < 0.6), drift
    assert res.residual < 1.0
