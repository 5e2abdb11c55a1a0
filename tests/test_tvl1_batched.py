"""The batched solver as one traced XLA program: per-pair equivalence,
the epsilon exit, jit against op-by-op execution, the gamma term, the
initial-flow path, and recovery of shifts past 8 px against the IPOL
oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optflow.core.config import TVL1Params
from optflow.ops.tvl1 import tvl1_flow, tvl1_flow_batched, tvl1_flow_level
from tests.conftest import make_fibsem_like
from tests.reference_tvl1 import tvl1_reference
from tests.test_tvl1 import mean_epe, translate


def _batch(rng, n, h, w, shifts):
    i0 = [make_fibsem_like(rng, h, w) for _ in range(n)]
    i1 = [translate(a, *shifts[k % len(shifts)]) for k, a in enumerate(i0)]
    return jnp.asarray(np.stack(i0)), jnp.asarray(np.stack(i1))


# widths and heights that are not multiples of 8 or 128, and one that is
@pytest.mark.parametrize("h,w", [(24, 40), (33, 47), (17, 130), (40, 128)])
def test_vmapped_level_equals_per_image_bitwise(rng, h, w):
    """At epsilon 0 the vmapped level solve equals each image's own solve
    bit for bit: batching adds no cross-image arithmetic."""
    i0, i1 = _batch(rng, 3, h, w, [(1.0, -0.5), (0.3, 0.8), (-1.2, 0.0)])
    p = TVL1Params(nscales=1, warps=2, iterations=15, epsilon=0.0)
    u = jnp.zeros((3, h, w), jnp.float32)
    level = jax.jit(jax.vmap(
        lambda a, b, x, y: tvl1_flow_level(a, b, x, y, p)[:2]))
    b1, b2 = level(i0, i1, u, u)
    solo = jax.jit(lambda a, b, x, y: tvl1_flow_level(a, b, x, y, p)[:2])
    for k in range(3):
        s1, s2 = solo(i0[k], i1[k], u[k], u[k])
        assert np.array_equal(np.asarray(b1[k]), np.asarray(s1))
        assert np.array_equal(np.asarray(b2[k]), np.asarray(s2))


@pytest.mark.parametrize("h,w", [(40, 56), (37, 61)])
def test_batched_pyramid_equals_per_pair_solve(rng, h, w):
    """The whole batched pyramid (one program) gives each pair its own
    single-pair solve, with the epsilon exit on: pairs that converge
    first hold their state while the batch iterates on."""
    i0, i1 = _batch(rng, 3, h, w, [(1.5, -0.5), (0.2, 0.1), (2.5, 1.0)])
    p = TVL1Params(nscales=3, warps=2, iterations=40, epsilon=0.01)
    batched = np.asarray(tvl1_flow_batched(i0, i1, p))
    single = jax.jit(lambda a, b: tvl1_flow(a, b, p))
    for k in range(3):
        ref = np.asarray(single(i0[k], i1[k]))
        assert np.abs(batched[k] - ref).max() < 1e-4


def test_epsilon_exit_stops_after_first_iteration(rng):
    """An epsilon every update satisfies exits after one iteration per
    warp: the result equals the fixed one-iteration solve (the while and
    fori loop forms compile to different fusions, so only rounding
    differs)."""
    i0, i1 = _batch(rng, 2, 32, 48, [(1.0, 0.5)])
    early = TVL1Params(nscales=2, warps=3, iterations=200, epsilon=1e3)
    one = TVL1Params(nscales=2, warps=3, iterations=1, epsilon=0.0)
    a = np.asarray(tvl1_flow_batched(i0, i1, early))
    b = np.asarray(tvl1_flow_batched(i0, i1, one))
    assert np.abs(a - b).max() < 1e-5
    two = TVL1Params(nscales=2, warps=3, iterations=2, epsilon=0.0)
    assert np.abs(a - np.asarray(tvl1_flow_batched(i0, i1, two))).max() > 1e-3


def test_epsilon_exit_within_tolerance_of_fixed_count(rng):
    """The reference epsilon (0.01) stops early yet lands within a small
    distance of the solve that runs every iteration, and both recover
    the known shift."""
    i0, i1 = _batch(rng, 2, 64, 80, [(1.5, -1.0)])
    eps = TVL1Params(nscales=3, warps=3, iterations=150, epsilon=0.01)
    full = TVL1Params(nscales=3, warps=3, iterations=150, epsilon=0.0)
    fe = np.asarray(tvl1_flow_batched(i0, i1, eps))
    ff = np.asarray(tvl1_flow_batched(i0, i1, full))
    assert not np.array_equal(fe, ff)  # the exit fired
    d = np.sqrt(((fe - ff) ** 2).sum(-1))[:, 8:-8, 8:-8]
    assert float(d.mean()) < 0.05
    for k in range(2):
        assert mean_epe(fe[k], 1.5, -1.0) < 0.25


def test_jitted_pyramid_equals_eager(rng):
    """Tracing the whole pyramid into one program changes nothing but
    rounding against op-by-op execution."""
    im0 = make_fibsem_like(rng, 40, 56)
    im1 = translate(im0, 1.0, -0.5)
    p = TVL1Params(nscales=3, warps=2, iterations=20, epsilon=0.0)
    jitted = np.asarray(jax.jit(lambda a, b: tvl1_flow(a, b, p))(im0, im1))
    with jax.disable_jit():
        eager = np.asarray(tvl1_flow(jnp.asarray(im0), jnp.asarray(im1), p))
    assert np.abs(jitted - eager).max() < 1e-4


def test_batched_gamma_term(rng):
    """gamma != 0 (the illumination-offset variable) runs through the
    batched entry, matches each pair's own solve, and still recovers a
    shift under a brightness change."""
    im0 = make_fibsem_like(rng, 48, 64)
    i0 = jnp.asarray(np.stack([im0, im0]))
    i1 = jnp.asarray(np.stack([translate(im0, 1.0, 0.0) + 5.0,
                               translate(im0, 0.5, 0.5)]))
    p = TVL1Params(nscales=3, warps=3, iterations=60, gamma=0.4)
    batched = np.asarray(tvl1_flow_batched(i0, i1, p))
    for k in range(2):
        ref = np.asarray(jax.jit(lambda a, b: tvl1_flow(a, b, p))(i0[k], i1[k]))
        assert np.abs(batched[k] - ref).max() < 1e-4
    assert mean_epe(batched[0], 1.0, 0.0) < 0.35
    plain = np.asarray(tvl1_flow_batched(i0, i1, TVL1Params(
        nscales=3, warps=3, iterations=60)))
    assert not np.allclose(plain, batched)


def test_batched_initial_flow(rng):
    """use_initial_flow through the batched entry: each pair starts from
    its own initial field."""
    i0, i1 = _batch(rng, 2, 32, 48, [(1.0, 0.0), (1.5, 0.5)])
    p = TVL1Params(nscales=1, warps=1, iterations=3, use_initial_flow=True)
    init = jnp.stack([jnp.full((2, 32, 48), 1.2), jnp.full((2, 32, 48), -0.7)],
                     axis=-1).astype(jnp.float32)
    got = np.asarray(tvl1_flow_batched(i0, i1, p, init_flow=init))
    zero = np.asarray(tvl1_flow_batched(i0, i1, p))
    for k in range(2):
        ref = np.asarray(tvl1_flow(i0[k], i1[k], p, init_flow=init[k]))
        assert np.abs(got[k] - ref).max() < 1e-5
    assert not np.allclose(got, zero, atol=1e-3)


def test_batched_compiles_once_per_shape_and_params(rng):
    """One compiled program per (shape, params): repeat calls reuse it,
    a new shape or new params add one."""
    p = TVL1Params(nscales=2, warps=1, iterations=5)
    i0, i1 = _batch(rng, 2, 24, 32, [(1.0, 0.0)])
    tvl1_flow_batched(i0, i1, p).block_until_ready()
    n0 = tvl1_flow_batched._cache_size()
    tvl1_flow_batched(i0 + 1.0, i1, p).block_until_ready()
    assert tvl1_flow_batched._cache_size() == n0
    tvl1_flow_batched(i0[:1], i1[:1], p).block_until_ready()
    tvl1_flow_batched(i0, i1, TVL1Params(nscales=2, warps=1,
                                         iterations=6)).block_until_ready()
    assert tvl1_flow_batched._cache_size() == n0 + 2


@pytest.mark.parametrize("dx,dy", [(12.0, 3.0), (20.0, -4.0)])
def test_large_shift_against_oracle(rng, dx, dy):
    """The gather warp has no magnitude contract: shifts of 12 and 20 px
    (past the 8 px bound the removed shift-compose warp had) solve to
    within the 0.5 px EPE budget of the IPOL oracle and of the truth."""
    # 128 rows keep all 10 reference levels, so a 20 px shift is under
    # 3 px at the coarsest level
    im0 = make_fibsem_like(rng, 128, 192)
    im1 = translate(im0, dx, dy)
    p = TVL1Params()
    flow = np.asarray(tvl1_flow_batched(
        jnp.asarray(im0)[None], jnp.asarray(im1)[None], p))[0]
    oracle = tvl1_reference(
        im0, im1, tau=p.tau, lambda_=p.lambda_, theta=p.theta,
        nscales=p.nscales, warps=p.warps, epsilon=p.epsilon,
        iterations=p.iterations, scale_step=p.scale_step,
    )
    m = np.s_[24:-24, 24:-24]
    d = np.sqrt(((flow[m] - oracle[m]) ** 2).sum(-1)).mean()
    assert d <= 0.5, f"EPE vs oracle at ({dx}, {dy}) = {d:.3f} px"
    assert mean_epe(flow, dx, dy, margin=24) <= 0.5
