"""Tests for stencil/warp primitives against numpy references and
analytic identities."""

import numpy as np
import jax.numpy as jnp
import pytest

from optflow.ops.warp import (
    affine_warp,
    bilinear_sample,
    centered_gradient,
    divergence,
    forward_gradient,
    invert_affine,
    warp_backward,
)


def test_centered_gradient_interior_and_border(rng):
    im = rng.standard_normal((8, 10)).astype(np.float32)
    gx, gy = centered_gradient(jnp.asarray(im))
    gx, gy = np.asarray(gx), np.asarray(gy)
    # interior
    assert np.allclose(gx[:, 1:-1], 0.5 * (im[:, 2:] - im[:, :-2]), atol=1e-6)
    assert np.allclose(gy[1:-1, :], 0.5 * (im[2:, :] - im[:-2, :]), atol=1e-6)
    # replicate border: half of one-sided difference
    assert np.allclose(gx[:, 0], 0.5 * (im[:, 1] - im[:, 0]), atol=1e-6)
    assert np.allclose(gx[:, -1], 0.5 * (im[:, -1] - im[:, -2]), atol=1e-6)


def test_forward_gradient_zero_at_far_border(rng):
    u = rng.standard_normal((6, 7)).astype(np.float32)
    ux, uy = forward_gradient(jnp.asarray(u))
    ux, uy = np.asarray(ux), np.asarray(uy)
    assert np.allclose(ux[:, :-1], u[:, 1:] - u[:, :-1], atol=1e-6)
    assert np.all(ux[:, -1] == 0)
    assert np.allclose(uy[:-1, :], u[1:, :] - u[:-1, :], atol=1e-6)
    assert np.all(uy[-1, :] == 0)


def test_divergence_adjoint_of_forward_gradient(rng):
    """<grad u, p> == -<u, div p> up to the boundary convention; with the
    OpenCV convention the pair satisfies <grad u, p> = -<u, div p> exactly
    when p's far-border rows/cols carry no weight, which forward_gradient
    guarantees (grad is 0 there)."""
    u = rng.standard_normal((9, 11)).astype(np.float32)
    p1 = rng.standard_normal((9, 11)).astype(np.float32)
    p2 = rng.standard_normal((9, 11)).astype(np.float32)
    # zero the components forward_gradient never produces
    p1[:, -1] = 0
    p2[-1, :] = 0
    ux, uy = forward_gradient(jnp.asarray(u))
    div = divergence(jnp.asarray(p1), jnp.asarray(p2))
    lhs = float(jnp.sum(ux * p1 + uy * p2))
    rhs = -float(jnp.sum(jnp.asarray(u) * div))
    assert abs(lhs - rhs) < 1e-3


def test_bilinear_sample_exact_on_grid(rng):
    im = rng.standard_normal((5, 6)).astype(np.float32)
    ys, xs = np.mgrid[0:5, 0:6].astype(np.float32)
    out = bilinear_sample(jnp.asarray(im), jnp.asarray(xs), jnp.asarray(ys))
    assert np.allclose(np.asarray(out), im, atol=1e-6)
    # cubic-hat variant also interpolates exactly at grid points
    out_c = bilinear_sample(
        jnp.asarray(im), jnp.asarray(xs), jnp.asarray(ys), cubic_hat=True
    )
    assert np.allclose(np.asarray(out_c), im, atol=1e-5)


def test_bilinear_sample_midpoint():
    im = jnp.asarray([[0.0, 2.0], [4.0, 6.0]], dtype=jnp.float32)
    v = bilinear_sample(im, jnp.asarray([[0.5]]), jnp.asarray([[0.5]]))
    assert np.allclose(np.asarray(v), [[3.0]], atol=1e-6)
    # clamp-to-edge out of range
    v2 = bilinear_sample(im, jnp.asarray([[-3.0]]), jnp.asarray([[5.0]]))
    assert np.allclose(np.asarray(v2), [[4.0]], atol=1e-6)


def test_warp_backward_integer_translation(rng):
    """Warping by an integer flow must reproduce a shifted copy in the
    interior and zero the linearized residual there."""
    im = rng.standard_normal((16, 20)).astype(np.float32) * 50 + 100
    i1 = np.roll(im, shift=(0, -2), axis=(0, 1))  # i1(x) = i0(x + 2)
    u2 = jnp.zeros((16, 20), jnp.float32)
    i1j = jnp.asarray(i1)
    i1x, i1y = centered_gradient(i1j)
    # choose u = -2 so i1w(x) = i1(x-2) = i0(x)
    u1 = jnp.full((16, 20), -2.0, jnp.float32)
    i1w, i1wx, i1wy, grad, rho_c = warp_backward(
        jnp.asarray(im), i1j, i1x, i1y, u1, u2
    )
    i1w = np.asarray(i1w)
    interior = (slice(2, -2), slice(4, -4))
    assert np.allclose(i1w[interior], im[interior], atol=1e-4)
    # linearized residual evaluated at the warping flow:
    # rho = rho_c + i1wx*u1 + i1wy*u2 = i1w - i0 = 0 in the interior
    rho = np.asarray(rho_c) + np.asarray(i1wx) * (-2.0)
    assert np.allclose(rho[interior], 0.0, atol=1e-3)


def test_invert_affine_roundtrip(rng):
    A = jnp.asarray(
        [[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0]], dtype=jnp.float32
    )
    Ainv = invert_affine(A)
    # compose: A o Ainv == identity
    M = np.asarray(A)
    Mi = np.asarray(Ainv)
    comp = M[:, :2] @ Mi[:, :2]
    t = M[:, :2] @ Mi[:, 2] + M[:, 2]
    assert np.allclose(comp, np.eye(2), atol=1e-5)
    assert np.allclose(t, 0, atol=1e-4)


def test_affine_warp_identity(rng):
    im = rng.standard_normal((12, 14)).astype(np.float32)
    ident = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0]], dtype=jnp.float32)
    out = affine_warp(jnp.asarray(im), ident)
    assert np.allclose(np.asarray(out), im, atol=1e-5)


def test_affine_warp_translation_constant_border(rng):
    im = rng.standard_normal((10, 10)).astype(np.float32) + 5.0
    # forward matrix translates +3 in x: dst(x,y) = src(x-3, y)
    A = jnp.asarray([[1.0, 0, 3.0], [0, 1.0, 0]], dtype=jnp.float32)
    out = np.asarray(affine_warp(jnp.asarray(im), A))
    assert np.allclose(out[:, 3:], im[:, :-3], atol=1e-5)
    assert np.allclose(out[:, :3], 0.0, atol=1e-6)  # constant-0 border


def test_affine_warp_output_shape(rng):
    im = rng.standard_normal((8, 8)).astype(np.float32)
    ident = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0]], dtype=jnp.float32)
    out = affine_warp(jnp.asarray(im), ident, out_shape=(12, 10))
    assert out.shape == (12, 10)
    assert np.allclose(np.asarray(out)[:8, :8], im, atol=1e-5)


def test_affine_warp_shift_matches_gather(rng):
    """The shift-compose affine warp (no gathers; used for frame
    pre-warping and map composition) must match the gather warp: exactly for pure translations, and to sub-intensity tolerance
    for small rotations/shears (its 2-pass factorization evaluates the
    X weights at the tap row — an error bounded by |shear| * s_max
    sample positions)."""
    from optflow.ops.warp import affine_warp, affine_warp_shift
    from tests.conftest import make_fibsem_like

    im = jnp.asarray(make_fibsem_like(rng, 96, 128))

    # pure (fractional) translation: identical up to float assoc
    aff_t = jnp.asarray(
        np.array([[1.0, 0.0, 7.3], [0.0, 1.0, -4.6]], np.float32)
    )
    a = np.asarray(affine_warp(im, aff_t))
    b, ncl = affine_warp_shift(im, aff_t)
    assert int(ncl) == 0
    assert np.allclose(a, np.asarray(b), atol=1e-3), (
        np.abs(a - np.asarray(b)).max()
    )

    # small rotation + scale (production regime): close, zero clamps
    th = 0.008
    aff_r = jnp.asarray(
        np.array(
            [[1.004 * np.cos(th), -np.sin(th), 3.0],
             [np.sin(th), 1.004 * np.cos(th), -2.0]],
            np.float32,
        )
    )
    a = np.asarray(affine_warp(im, aff_r))
    b, ncl = affine_warp_shift(im, aff_r)
    assert int(ncl) == 0
    # interior comparison (borders differ by fill-edge handling order)
    d = np.abs(a - np.asarray(b))[8:-8, 8:-8]
    assert float(d.max()) < 1.5, float(d.max())

    # a rotation far beyond the residual bound flags clamps
    th = 0.5
    aff_big = jnp.asarray(
        np.array(
            [[np.cos(th), -np.sin(th), 0.0],
             [np.sin(th), np.cos(th), 0.0]],
            np.float32,
        )
    )
    _, ncl = affine_warp_shift(im, aff_big)
    assert int(ncl) > 0
