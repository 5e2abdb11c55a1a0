"""Distributed global stack alignment: edge-sharded CG over a device mesh.

The single-device solver (align/global_solve.py) builds the match-graph
normal equations and runs preconditioned CG; for pod-scale stacks
(thousands of sections, millions of matches — the Sec26 VNC production
graph spans z=1..9604 at z-distance <= 3, docs/example_gen_cross:1) the
edge set is sharded across the mesh's ``pairs`` axis and each CG matvec
reduces partial gather/scatter contributions with a psum — the
collectives-first structure SURVEY.md §2.4 prescribes for the z-axis
("sequence") dimension. The per-section state (Z, 2) is small and kept
replicated; only the O(edges) work distributes.

Matvec per shard: diff = t[a] - t[b] on local edges; scatter-add into a
local (Z, 2) accumulator; psum over the mesh -> identical full matvec on
every device. The result is numerically the same solve as the
single-device path (tested for agreement).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from optflow.align.global_solve import (
    AlignmentResult,
    _cg,
    _collect_edges,
)


def solve_affine_alignment_sharded(
    matches: Sequence[dict],
    mesh: Mesh,
    axis_name: str = "pairs",
    reg_lambda: float = 1e-3,
    iters: int = 400,
    tol: float = 1e-8,
) -> AlignmentResult:
    """Edge-sharded equivalent of solve_affine_alignment: each device owns
    an edge shard, the Gauss-Newton matvec's gather/scatter runs on local
    edges, and partial (Z, 6) accumulators reduce with one psum per matvec
    (same collective structure as the translation solve)."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        ident = np.tile(
            np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (max(z, 0), 1, 1)
        )
        return AlignmentResult(group_ids, ident, 0.0)

    n_shards = mesh.shape[axis_name]
    m = len(w)
    m_pad = -(-m // n_shards) * n_shards

    def pad(x, fill=0):
        out = np.full((m_pad,) + x.shape[1:], fill, x.dtype)
        out[:m] = x
        return out

    a_p = pad(a_idx)
    b_p = pad(b_idx)
    w_p = pad(w.astype(np.float32))
    p_p = pad(p.astype(np.float32))
    q_p = pad(q.astype(np.float32))

    pin = 2.0 * float(np.sum(w)) + 1.0

    hi = jax.lax.Precision.HIGHEST

    def shard_solve(a_s, b_s, w_s, p_s, q_s):
        ones = jnp.ones((p_s.shape[0], 1))
        ph_a = jnp.concatenate([p_s, ones], axis=1)  # (m, 3)
        ph_b = jnp.concatenate([q_s, ones], axis=1)

        # x: (Z, 6) delta-from-identity [a11, a12, tx, a21, a22, ty].
        # The x/y parameter rows share the same per-edge coefficients
        # (ph_a at a, -ph_b at b), so the residual Jacobian factors.
        def jv_edges(x):
            xa = x[a_s].reshape(-1, 2, 3)
            xb = x[b_s].reshape(-1, 2, 3)
            return (
                jnp.einsum("mij,mj->mi", xa, ph_a, precision=hi)
                - jnp.einsum("mij,mj->mi", xb, ph_b, precision=hi)
            )  # (m, 2)

        def jt_edges(r):  # r: (m, 2) -> (Z, 6) with psum
            ga = jnp.einsum("mi,mj->mij", r, ph_a, precision=hi)
            gb = -jnp.einsum("mi,mj->mij", r, ph_b, precision=hi)
            ga = ga.reshape(-1, 6)
            gb = gb.reshape(-1, 6)
            out = jnp.zeros((z, 6))
            out = out.at[a_s].add(ga)
            out = out.at[b_s].add(gb)
            return jax.lax.psum(out, axis_name)

        def matvec(x):
            out = jt_edges(w_s[:, None] * jv_edges(x))
            out = out + reg_lambda * x
            out = out.at[0].add(pin * x[0])
            return out

        # residual at x=0: p + 0 - (q + 0) per edge component-wise with the
        # identity baseline: r0 = p - q (the affine deltas must absorb it)
        r0 = p_s - q_s
        rhs = jt_edges(-w_s[:, None] * r0)

        M_inv = jnp.ones((z, 6))
        return _cg(matvec, rhs, M_inv, iters, tol)

    spec = P(axis_name)
    fn = jax.shard_map(
        shard_solve,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec),
        out_specs=P(),
        check_vma=False,
    )
    sharding = NamedSharding(mesh, spec)
    x = fn(
        jax.device_put(jnp.asarray(a_p), sharding),
        jax.device_put(jnp.asarray(b_p), sharding),
        jax.device_put(jnp.asarray(w_p), sharding),
        jax.device_put(jnp.asarray(p_p), sharding),
        jax.device_put(jnp.asarray(q_p), sharding),
    )
    x_np = np.asarray(x).reshape(z, 2, 3)

    transforms = np.tile(
        np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (z, 1, 1)
    )
    transforms[:, :, :2] += x_np[:, :, :2]
    transforms[:, :, 2] += x_np[:, :, 2]

    ph_p = np.concatenate([p, np.ones((m, 1), np.float32)], axis=1)
    ph_q = np.concatenate([q, np.ones((m, 1), np.float32)], axis=1)
    res = np.einsum("mij,mj->mi", transforms[a_idx], ph_p) - np.einsum(
        "mij,mj->mi", transforms[b_idx], ph_q
    )
    rms = float(np.sqrt((res**2).sum(axis=1).mean()))
    return AlignmentResult(group_ids, transforms, rms)


def solve_translation_alignment_sharded(
    matches: Sequence[dict],
    mesh: Mesh,
    axis_name: str = "pairs",
    iters: int = 200,
    tol: float = 1e-6,
) -> AlignmentResult:
    """Edge-sharded equivalent of solve_translation_alignment."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, np.zeros((z, 2, 3), np.float32), 0.0)

    n_shards = mesh.shape[axis_name]
    m = len(w)
    m_pad = -(-m // n_shards) * n_shards

    def pad(x, fill=0):
        out = np.full((m_pad,) + x.shape[1:], fill, x.dtype)
        out[:m] = x
        return out

    # padding edges carry weight 0 -> no contribution
    a_p = pad(a_idx)
    b_p = pad(b_idx)
    w_p = pad(w.astype(np.float32))
    d_p = pad((q - p).astype(np.float32))

    pin = 2.0 * float(np.sum(w)) + 1.0

    def shard_solve(a_s, b_s, w_s, d_s):
        # every device sees its own edge shard; t is replicated
        def matvec(t):
            diff = t[a_s] - t[b_s]
            out = jnp.zeros((z, 2))
            out = out.at[a_s].add(w_s[:, None] * diff)
            out = out.at[b_s].add(-w_s[:, None] * diff)
            out = jax.lax.psum(out, axis_name)
            out = out.at[0].add(pin * t[0])
            return out

        rhs = jnp.zeros((z, 2))
        rhs = rhs.at[a_s].add(w_s[:, None] * d_s)
        rhs = rhs.at[b_s].add(-w_s[:, None] * d_s)
        rhs = jax.lax.psum(rhs, axis_name)

        deg = jnp.zeros((z,))
        deg = deg.at[a_s].add(w_s)
        deg = deg.at[b_s].add(w_s)
        deg = jax.lax.psum(deg, axis_name)
        deg = deg.at[0].add(pin)
        M_inv = (1.0 / jnp.maximum(deg, 1e-9))[:, None] * jnp.ones((1, 2))
        return _cg(matvec, rhs, M_inv, iters, tol)

    spec = P(axis_name)
    fn = jax.shard_map(
        shard_solve,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=P(),  # replicated result
        check_vma=False,
    )
    sharding = NamedSharding(mesh, spec)
    t = fn(
        jax.device_put(jnp.asarray(a_p), sharding),
        jax.device_put(jnp.asarray(b_p), sharding),
        jax.device_put(jnp.asarray(w_p), sharding),
        jax.device_put(jnp.asarray(d_p), sharding),
    )
    t_np = np.asarray(t)

    transforms = np.tile(
        np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (z, 1, 1)
    )
    transforms[:, 0, 2] = t_np[:, 0]
    transforms[:, 1, 2] = t_np[:, 1]
    res = (p + t_np[a_idx]) - (q + t_np[b_idx])
    rms = float(np.sqrt((res**2).sum(axis=1).mean()))
    return AlignmentResult(group_ids, transforms, rms)
