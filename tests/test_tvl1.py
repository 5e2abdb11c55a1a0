"""TV-L1 solver tests: pyramid geometry, zero-flow on identical frames,
EPE on synthetic translations/rotations, useInitialFlow, batching."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optflow.core.config import TVL1Params
from optflow.ops.pyramid import build_pyramid, pyramid_shapes, upscale_flow
from optflow.ops.tvl1 import tvl1_flow
from tests.conftest import make_fibsem_like

# A cheaper parameter set for tests (same structure, fewer iterations).
FAST = TVL1Params(nscales=4, warps=3, iterations=60, epsilon=0.01)


def mean_epe(flow, gt_u, gt_v, margin=8):
    f = np.asarray(flow)
    err = np.sqrt(
        (f[..., 0] - gt_u) ** 2 + (f[..., 1] - gt_v) ** 2
    )
    if margin:
        err = err[margin:-margin, margin:-margin]
    return float(err.mean())


def translate(im, dx, dy):
    """Return im1 with im1(x + dx) = im(x), i.e. the scene moves by (dx, dy)
    and the ground-truth flow from im to im1 (OpenCV convention:
    prev(x) ~ next(x + flow)) is (dx, dy)."""
    import scipy.ndimage as ndi

    h, w = im.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return ndi.map_coordinates(
        im, [ys - dy, xs - dx], order=3, mode="nearest"
    ).astype(np.float32)


def test_pyramid_shapes_respects_min_dim():
    shapes = pyramid_shapes(100, 100, 10, 0.8)
    assert shapes[0] == (100, 100)
    for (h, w) in shapes:
        assert h >= 16 and w >= 16
    # with scaleStep 0.8, 100 -> 80 -> 64 -> 51 -> 41 -> 33 -> 26 -> 21 -> 17 -> (13 stops)
    assert len(shapes) == 9


def test_pyramid_shapes_round_semantics():
    shapes = pyramid_shapes(100, 100, 3, 0.8)
    assert shapes == [(100, 100), (80, 80), (64, 64)]


def test_build_pyramid_chained(rng):
    im = jnp.asarray(make_fibsem_like(rng, 64, 64))
    shapes = pyramid_shapes(64, 64, 4, 0.8)
    levels = build_pyramid(im, shapes)
    assert [tuple(l.shape) for l in levels] == shapes
    # downsampled level preserves mean roughly
    assert abs(float(levels[-1].mean()) - float(im.mean())) < 8.0


def test_upscale_flow_magnitude():
    u1 = jnp.full((10, 10), 1.0, jnp.float32)
    u2 = jnp.full((10, 10), -2.0, jnp.float32)
    a, b = upscale_flow(u1, u2, (13, 13), 0.8)
    assert a.shape == (13, 13)
    assert np.allclose(np.asarray(a), 1.25, atol=1e-5)
    assert np.allclose(np.asarray(b), -2.5, atol=1e-5)


def test_identical_frames_zero_flow(rng):
    im = make_fibsem_like(rng, 64, 80)
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im), FAST)
    assert flow.shape == (64, 80, 2)
    assert float(jnp.abs(flow).max()) < 0.05


def test_small_translation_epe(rng):
    im = make_fibsem_like(rng, 96, 128)
    dx, dy = 1.5, -0.75
    im1 = translate(im, dx, dy)
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im1), FAST)
    epe = mean_epe(flow, dx, dy)
    assert epe < 0.25, f"EPE {epe} too high for subpixel translation"


def test_larger_translation_uses_pyramid(rng):
    im = make_fibsem_like(rng, 128, 128, smooth=10)
    dx, dy = 6.0, 4.0
    im1 = translate(im, dx, dy)
    params = TVL1Params(nscales=6, warps=4, iterations=80, epsilon=0.01)
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im1), params)
    epe = mean_epe(flow, dx, dy, margin=12)
    assert epe < 0.5, f"EPE {epe} too high for large translation"


def test_smooth_nonuniform_flow(rng):
    """A slowly-varying shear field must be recovered within tolerance."""
    import scipy.ndimage as ndi

    im = make_fibsem_like(rng, 96, 96, smooth=8)
    h, w = im.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    gt_u = 1.0 + 1.5 * (ys / h)  # x displacement varies with row
    gt_v = 0.5 * (xs / w)
    # im1(x) = im(x - gt(x)): for a slowly-varying field this matches the
    # forward-flow ground truth to O(|grad gt|*|gt|) ~ 0.03 px here.
    im1 = ndi.map_coordinates(
        im, [ys - gt_v, xs - gt_u], order=3, mode="nearest"
    ).astype(np.float32)
    params = TVL1Params(nscales=5, warps=4, iterations=100, epsilon=0.005)
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im1), params)
    epe = mean_epe(flow, gt_u, gt_v, margin=10)
    assert epe < 0.35, f"EPE {epe} too high for smooth field"


def test_use_initial_flow(rng):
    im = make_fibsem_like(rng, 64, 64)
    im1 = translate(im, 2.0, 0.0)
    init = jnp.stack(
        [jnp.full((64, 64), 2.0), jnp.zeros((64, 64))], axis=-1
    ).astype(jnp.float32)
    params = TVL1Params(
        nscales=1, warps=2, iterations=40, use_initial_flow=True
    )
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im1), params, init_flow=init)
    epe = mean_epe(flow, 2.0, 0.0)
    assert epe < 0.3


def test_epsilon_zero_runs_fixed_iterations(rng):
    im = make_fibsem_like(rng, 48, 48)
    im1 = translate(im, 0.5, 0.5)
    p0 = TVL1Params(nscales=3, warps=2, iterations=30, epsilon=0.0)
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im1), p0)
    assert mean_epe(flow, 0.5, 0.5) < 0.3


def test_vmap_batched_pairs(rng):
    ims = np.stack([make_fibsem_like(rng, 48, 64) for _ in range(3)])
    im1s = np.stack([translate(im, 1.0, -1.0) for im in ims])
    batched = jax.vmap(lambda a, b: tvl1_flow(a, b, FAST))
    flows = batched(jnp.asarray(ims), jnp.asarray(im1s))
    assert flows.shape == (3, 48, 64, 2)
    for i in range(3):
        assert mean_epe(flows[i], 1.0, -1.0) < 0.35


def test_gamma_illumination_term(rng):
    """gamma > 0 tolerates a global brightness offset between frames."""
    im = make_fibsem_like(rng, 64, 64)
    im1 = translate(im, 1.0, 0.0) + 10.0  # brightness shift
    p = TVL1Params(nscales=4, warps=3, iterations=60, gamma=0.3)
    flow = tvl1_flow(jnp.asarray(im), jnp.asarray(im1), p)
    epe_gamma = mean_epe(flow, 1.0, 0.0)
    assert epe_gamma < 0.5
