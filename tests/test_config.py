"""Config-system tests: precedence, tri-state features, gz loading,
comment-tolerant parsing (the documented schema docs/example.json uses
JS-style comments)."""

import gzip
import json

from optflow.core.config import (
    JobConfig,
    MatchParams,
    OrbParams,
    SurfParams,
    TVL1Params,
    cfg_get,
    feature_type,
    load_job,
    parse_job_text,
    resolve_features,
)


def test_precedence_im_over_args_over_default():
    im = {"tau": 0.5}
    args = {"tau": 0.1, "lambda": 0.2}
    assert cfg_get(im, args, "tau", 0.25) == 0.5
    assert cfg_get(im, args, "lambda", 0.05) == 0.2
    assert cfg_get(im, args, "theta", 0.3) == 0.3


def test_tv_params_defaults_match_reference():
    p = TVL1Params.from_config({}, {})
    assert p.tau == 0.25
    assert p.lambda_ == 0.05
    assert p.theta == 0.3
    assert p.nscales == 10
    assert p.warps == 5
    assert p.epsilon == 0.01
    assert p.iterations == 300
    assert p.scale_step == 0.8
    assert p.gamma == 0.0
    assert p.use_initial_flow is False


def test_tv_params_overrides():
    p = TVL1Params.from_config({"nscales": 3}, {"iterations": 7, "nscales": 5})
    assert p.nscales == 3
    assert p.iterations == 7


def test_tristate_features():
    # explicit false at image level wins even if global true
    assert resolve_features({"features": False}, {"features": 2}) is False
    assert resolve_features({"features": 0}, {"features": 2}) is False
    # explicit false at job level wins unless image sets truthy...
    # reference order: im false -> args false -> (im truthy or args truthy)
    assert resolve_features({"features": 2}, {"features": False}) is False
    assert resolve_features({}, {"features": False}) is False
    # truthy enables
    assert resolve_features({"features": 1}, {}) is True
    assert resolve_features({}, {"features": 2}) is True
    # absent everywhere -> disabled
    assert resolve_features({}, {}) is False


def test_feature_type_default_surf():
    assert feature_type({}, {}) == 2
    assert feature_type({"features": 1}, {"features": 2}) == 1


def test_detector_param_defaults():
    orb = OrbParams.from_config({}, {})
    assert orb.nfeatures == 5000 and orb.fast_threshold == 20
    surf = SurfParams.from_config({}, {})
    assert surf.hessian_threshold == 400 and surf.n_octaves == 4
    m = MatchParams.from_config({}, {})
    assert m.ratio == 0.8 and m.homo == 4 and m.ransac == 5.0


def test_parse_comments_and_trailing_commas():
    text = """
    {
      // line comment
      "style": 1, /* block comment */
      "scale": 0.5,
      "images": [ {"p": "a.png", "q": "b.png",} ],
    }
    """
    d = parse_job_text(text)
    assert d["style"] == 1
    assert d["images"][0]["q"] == "b.png"


def test_load_gz_job(tmp_path):
    job = {"style": 1, "scale": 0.25, "images": []}
    p = tmp_path / "job.json.gz"
    with gzip.open(p, "wt") as f:
        json.dump(job, f)
    loaded = load_job(str(p))
    assert loaded["scale"] == 0.25


def test_output_path_composition(tmp_path):
    cfg = JobConfig({"output_dir": "/out", "scale": 0.5})
    assert cfg.output_path({"output_name": "t1"}) == "/out/t1_0.50"
    # per-image scale changes the suffix
    assert cfg.output_path({"output_name": "t1", "scale": 1.0}) == "/out/t1_1.00"
    # explicit per-image output wins
    assert cfg.output_path({"output": "/x/y"}) == "/x/y"


def test_jobconfig_accessors():
    cfg = JobConfig({"output_type": "random_points", "npoints": 7})
    assert cfg.output_type({}) == "random_points"
    assert cfg.output_type({"output_type": "map"}) == "map"
    assert cfg.npoints({}) == 7
    assert cfg.batch_size() == 100
    assert cfg.style == 1
