"""Coarse-to-fine TV-L1 dense optical flow — the framework's core solver.

A reimplementation of the duality-based TV-L1 scheme
(Zach/Pock/Bischof primal-dual with flow linearization) that the reference
invokes through cv::cuda::OpticalFlowDual_TVL1 (src/optflow.cpp:516-520) with
the tuned defaults of generate_TV_args (src/optflow.cpp:500-514): tau=0.25,
lambda=0.05, theta=0.3, nscales=10, warps=5, epsilon=0.01, iterations=300,
scaleStep=0.8, gamma=0.

Per pyramid level (coarse -> fine):
  p (dual) zeroed once per level; then ``warps`` times:
    - warp (I1, I1x, I1y) backward by current flow, linearize residual rho_c
    - up to ``iterations`` primal-dual updates with early exit when the mean
      squared flow update drops below epsilon^2 (checked per iteration, as
      the reference solver does when epsilon > 0)
  then the flow is upsampled to the next finer level and scaled by
  1/scaleStep.

The primal update is the closed-form soft-threshold on the linearized
residual followed by u = v + theta * div(p); the dual update is a
forward-difference gradient ascent projected via p <- (p + taut*grad u)
/ (1 + taut*|grad u|), taut = tau/theta.

When ``gamma > 0`` a third primal variable u3 (illumination offset) with its
own dual pair is solved, following the same extension the GPU solver
implements (grad' = grad + gamma^2; rho includes gamma*u3).

All state is (H, W) float32; the whole function is jit/vmap/shard_map
friendly (static shapes per pyramid level, lax loops only). Each level,
the pyramid build and the flow upscaling carry a ``jax.named_scope`` so a
profiler trace attributes device time to them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from optflow.core.config import TVL1Params
from optflow.ops.pyramid import (
    build_pyramid,
    pyramid_shapes,
    resize_bilinear,
    upscale_flow,
)
from optflow.ops.warp import (
    centered_gradient,
    divergence,
    forward_gradient,
    warp_backward,
)

_GRAD_EPS = 1.192092896e-07  # FLT_EPSILON guard on the |grad I1w|^2 division


class _LevelState(NamedTuple):
    u1: jnp.ndarray
    u2: jnp.ndarray
    u3: jnp.ndarray
    p11: jnp.ndarray
    p12: jnp.ndarray
    p21: jnp.ndarray
    p22: jnp.ndarray
    p31: jnp.ndarray
    p32: jnp.ndarray


def _iteration(
    state: _LevelState,
    i1wx: jnp.ndarray,
    i1wy: jnp.ndarray,
    grad: jnp.ndarray,
    rho_c: jnp.ndarray,
    l_t: float,
    theta: float,
    taut: float,
    gamma: float,
) -> Tuple[_LevelState, jnp.ndarray]:
    """One primal-dual update. Returns (new_state, sum of squared flow
    updates) — the error the epsilon stop criterion monitors."""
    u1, u2, u3 = state.u1, state.u2, state.u3
    use_gamma = gamma != 0.0

    rho = rho_c + i1wx * u1 + i1wy * u2
    g = grad
    if use_gamma:
        rho = rho + gamma * u3
        g = grad + gamma * gamma

    # Closed-form primal step on the linearized data term (soft threshold).
    lo = rho < -l_t * g
    hi = rho > l_t * g
    fi = -rho / jnp.maximum(g, _GRAD_EPS)
    mid_ok = g > _GRAD_EPS

    d1 = jnp.where(lo, l_t * i1wx, jnp.where(hi, -l_t * i1wx, jnp.where(mid_ok, fi * i1wx, 0.0)))
    d2 = jnp.where(lo, l_t * i1wy, jnp.where(hi, -l_t * i1wy, jnp.where(mid_ok, fi * i1wy, 0.0)))

    v1 = u1 + d1
    v2 = u2 + d2

    u1_new = v1 + theta * divergence(state.p11, state.p12)
    u2_new = v2 + theta * divergence(state.p21, state.p22)

    if use_gamma:
        d3 = jnp.where(lo, l_t * gamma, jnp.where(hi, -l_t * gamma, jnp.where(mid_ok, fi * gamma, 0.0)))
        v3 = u3 + d3
        u3_new = v3 + theta * divergence(state.p31, state.p32)
    else:
        u3_new = u3

    err = jnp.sum((u1_new - u1) ** 2 + (u2_new - u2) ** 2)

    # Dual ascent with pointwise projection.
    u1x, u1y = forward_gradient(u1_new)
    u2x, u2y = forward_gradient(u2_new)
    ng1 = 1.0 + taut * jnp.sqrt(u1x * u1x + u1y * u1y)
    ng2 = 1.0 + taut * jnp.sqrt(u2x * u2x + u2y * u2y)
    p11 = (state.p11 + taut * u1x) / ng1
    p12 = (state.p12 + taut * u1y) / ng1
    p21 = (state.p21 + taut * u2x) / ng2
    p22 = (state.p22 + taut * u2y) / ng2

    if use_gamma:
        u3x, u3y = forward_gradient(u3_new)
        ng3 = 1.0 + taut * jnp.sqrt(u3x * u3x + u3y * u3y)
        p31 = (state.p31 + taut * u3x) / ng3
        p32 = (state.p32 + taut * u3y) / ng3
    else:
        p31, p32 = state.p31, state.p32

    return (
        _LevelState(u1_new, u2_new, u3_new, p11, p12, p21, p22, p31, p32),
        err,
    )


def tvl1_flow_level(
    i0: jnp.ndarray,
    i1: jnp.ndarray,
    u1: jnp.ndarray,
    u2: jnp.ndarray,
    params: TVL1Params,
    u3: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run warps x iterations primal-dual at a single pyramid level."""
    l_t = params.lambda_ * params.theta
    taut = params.tau / params.theta
    h, w = i0.shape
    scaled_eps = params.epsilon * params.epsilon * h * w

    i1x, i1y = centered_gradient(i1)
    zeros = jnp.zeros_like(i0)
    if u3 is None:
        u3 = zeros
    state = _LevelState(u1, u2, u3, *([zeros] * 6))

    step = functools.partial(
        _iteration,
        l_t=l_t,
        theta=params.theta,
        taut=taut,
        gamma=params.gamma,
    )

    def one_warp(_, state: _LevelState) -> _LevelState:
        _, i1wx, i1wy, grad, rho_c = warp_backward(
            i0, i1, i1x, i1y, state.u1, state.u2
        )

        if params.epsilon > 0:
            def cond(carry):
                n, _, err = carry
                return (n < params.iterations) & (err > scaled_eps)

            def body(carry):
                n, st, _ = carry
                st, err = step(st, i1wx, i1wy, grad, rho_c)
                return n + 1, st, err

            _, state, _ = jax.lax.while_loop(
                cond, body, (0, state, jnp.float32(jnp.inf))
            )
        else:
            def body(_, st):
                st, _ = step(st, i1wx, i1wy, grad, rho_c)
                return st

            state = jax.lax.fori_loop(0, params.iterations, body, state)
        return state

    state = jax.lax.fori_loop(0, params.warps, one_warp, state)
    return state.u1, state.u2, state.u3


def tvl1_flow(
    i0: jnp.ndarray,
    i1: jnp.ndarray,
    params: TVL1Params = TVL1Params(),
    init_flow: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Full coarse-to-fine TV-L1 flow from i0 to i1.

    Args:
      i0, i1: (H, W) float32 grayscale frames, 0..255 intensity scale.
      params: solver parameters (reference defaults).
      init_flow: optional (H, W, 2) initial flow, honored when
        ``params.use_initial_flow`` (the reference's useInitialFlow key).

    Returns:
      (H, W, 2) float32 flow with [..., 0] = x displacement, [..., 1] = y,
      matching the reference's CV_32FC2 flow layout split at
      src/optflow.cpp:403-404.
    """
    h, w = i0.shape
    shapes = pyramid_shapes(h, w, params.nscales, params.scale_step)
    with jax.named_scope("tvl1_pyramid"):
        i0s = build_pyramid(i0.astype(jnp.float32), shapes)
        i1s = build_pyramid(i1.astype(jnp.float32), shapes)

    coarsest = shapes[-1]
    if params.use_initial_flow and init_flow is not None:
        u1 = init_flow[..., 0]
        u2 = init_flow[..., 1]
        for shape in shapes[1:]:
            u1 = resize_bilinear(u1, shape) * params.scale_step
            u2 = resize_bilinear(u2, shape) * params.scale_step
    else:
        u1 = jnp.zeros(coarsest, jnp.float32)
        u2 = jnp.zeros(coarsest, jnp.float32)
    u3 = jnp.zeros(coarsest, jnp.float32)

    for s in range(len(shapes) - 1, -1, -1):
        with jax.named_scope(f"tvl1_level{s}"):
            u1, u2, u3 = tvl1_flow_level(i0s[s], i1s[s], u1, u2, params, u3=u3)
        if s > 0:
            with jax.named_scope("tvl1_upscale"):
                u1, u2 = upscale_flow(u1, u2, shapes[s - 1], params.scale_step)
                u3 = resize_bilinear(u3, shapes[s - 1])

    return jnp.stack([u1, u2], axis=-1)


@functools.partial(jax.jit, static_argnames=("params",))
def tvl1_flow_batched(
    i0s: jnp.ndarray,  # (N, H, W)
    i1s: jnp.ndarray,
    params: TVL1Params = TVL1Params(),
    init_flow: Optional[jnp.ndarray] = None,  # (N, H, W, 2)
) -> jnp.ndarray:
    """Batched coarse-to-fine TV-L1 over a leading pair axis: one compiled
    program per (shape, params) covering the whole batched pyramid.

    Each pair keeps its own epsilon exit: the vmapped ``while_loop`` runs
    until the slowest pair of the batch converges, and pairs that have
    converged hold their state, so every pair's flow equals its
    single-pair solve.
    """
    if init_flow is None:
        return jax.vmap(lambda a, b: tvl1_flow(a, b, params))(i0s, i1s)
    return jax.vmap(
        lambda a, b, f: tvl1_flow(a, b, params, init_flow=f)
    )(i0s, i1s, init_flow)
