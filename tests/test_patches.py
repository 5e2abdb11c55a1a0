"""features.patches: matmul patch extraction/sampling vs the gather oracle.

The extractor replaces per-keypoint bilinear gathers (ops.warp
.bilinear_sample under vmap) with matmul contractions; these tests pin
numerical agreement with that oracle, including the clamp-to-edge border
semantics, in float32 (exact) and bfloat16 (production, loose tol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optflow.features.patches import extract_patches, sample_patches
from optflow.ops.warp import bilinear_sample


@pytest.fixture
def im(rng):
    return jnp.asarray(rng.uniform(0, 255, size=(96, 144)).astype(np.float32))


def _oracle_patch(im, x, y, sigma, p, step):
    c = (p - 1) / 2.0
    grid = (np.arange(p, dtype=np.float32) - c) * step
    sy = y + sigma * grid[:, None] + 0 * grid[None, :]
    sx = x + sigma * grid[None, :] + 0 * grid[:, None]
    sy = jnp.broadcast_to(jnp.asarray(sy), (p, p))
    sx = jnp.broadcast_to(jnp.asarray(sx), (p, p))
    return bilinear_sample(im, sx, sy)


def test_extract_matches_gather_oracle_f32(im, rng):
    k = 37  # not a chunk multiple — exercises padding
    xs = jnp.asarray(rng.uniform(5, 130, size=k).astype(np.float32))
    ys = jnp.asarray(rng.uniform(5, 90, size=k).astype(np.float32))
    sig = jnp.asarray(rng.uniform(0.8, 3.0, size=k).astype(np.float32))
    pats = extract_patches(
        im[None], xs, ys, sig, 16, 1.0, dtype=jnp.float32
    )[0]
    for i in [0, 11, 36]:
        want = _oracle_patch(
            im, float(xs[i]), float(ys[i]), float(sig[i]), 16, 1.0
        )
        np.testing.assert_allclose(pats[i], want, rtol=1e-5, atol=1e-3)


def test_extract_clamps_at_border(im):
    # keypoint hanging off the image: taps clamp to the edge row/col,
    # matching bilinear_sample's clamp-to-edge
    xs = jnp.asarray([1.0], jnp.float32)
    ys = jnp.asarray([0.5], jnp.float32)
    sig = jnp.asarray([2.0], jnp.float32)
    pats = extract_patches(im[None], xs, ys, sig, 8, 1.0, dtype=jnp.float32)[0]
    want = _oracle_patch(im, 1.0, 0.5, 2.0, 8, 1.0)
    np.testing.assert_allclose(pats[0], want, rtol=1e-5, atol=1e-3)


def test_extract_bf16_close(im, rng):
    k = 8
    xs = jnp.asarray(rng.uniform(20, 120, size=k).astype(np.float32))
    ys = jnp.asarray(rng.uniform(20, 70, size=k).astype(np.float32))
    sig = jnp.ones(k, jnp.float32) * 1.5
    p32 = extract_patches(im[None], xs, ys, sig, 16, 1.0, dtype=jnp.float32)
    pbf = extract_patches(im[None], xs, ys, sig, 16, 1.0)
    # bf16 weights/pixels: ~0.4% relative error on 0..255 data
    assert float(jnp.max(jnp.abs(p32 - pbf))) < 2.5


def test_sample_patches_matches_direct_bilinear(im, rng):
    # sampling the patch at its own grid nodes returns the patch values;
    # sampling between nodes agrees with bilinear interp of the patch
    k, p, s = 5, 12, 40
    xs = jnp.asarray(rng.uniform(30, 100, size=k).astype(np.float32))
    ys = jnp.asarray(rng.uniform(30, 60, size=k).astype(np.float32))
    sig = jnp.ones(k, jnp.float32)
    pats = extract_patches(im[None], xs, ys, sig, p, 1.0, dtype=jnp.float32)[0]
    px = jnp.asarray(rng.uniform(0, p - 1, size=(k, s)).astype(np.float32))
    py = jnp.asarray(rng.uniform(0, p - 1, size=(k, s)).astype(np.float32))
    got = sample_patches(pats, px, py, dtype=jnp.float32)
    for i in range(k):
        want = bilinear_sample(pats[i], px[i], py[i])
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-3)


def test_multichannel_extraction(im, rng):
    ims = jnp.stack([im, im * 2.0 + 1.0])
    xs = jnp.asarray([40.0], jnp.float32)
    ys = jnp.asarray([40.0], jnp.float32)
    sig = jnp.asarray([1.0], jnp.float32)
    pats = extract_patches(ims, xs, ys, sig, 8, 1.0, dtype=jnp.float32)
    np.testing.assert_allclose(
        pats[1], pats[0] * 2.0 + 1.0, rtol=1e-5, atol=1e-3
    )


def test_vmappable_over_pairs(im, rng):
    """The batched aligner vmaps the whole pipeline over pairs; the
    chunked scan inside extract_patches must batch cleanly."""
    ims = jnp.stack([im, im * 1.5 + 3.0])
    xs = jnp.asarray(rng.uniform(20, 80, size=(2, 9)).astype(np.float32))
    ys = jnp.asarray(rng.uniform(20, 80, size=(2, 9)).astype(np.float32))
    sig = jnp.ones((2, 9), jnp.float32)

    out = jax.vmap(
        lambda a, b, c, d: extract_patches(
            a[None], b, c, d, 8, 1.0, dtype=jnp.float32
        )
    )(ims, xs, ys, sig)
    assert out.shape == (2, 1, 9, 8, 8)
    want = extract_patches(
        ims[0][None], xs[0], ys[0], sig[0], 8, 1.0, dtype=jnp.float32
    )
    np.testing.assert_allclose(out[0], want, rtol=1e-5, atol=1e-3)
