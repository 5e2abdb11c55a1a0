"""Global stack alignment from accumulated point matches.

The reference emits point matches to the Janelia Render service and leaves
the global solve to external tooling (SURVEY.md §1: "the system's
parameter server"); the driver's north star asks for the solve in-process.
Given the match collection (Render schema, as produced by the engine's
sinks), estimate one transform per section (group) that aligns the whole
stack:

- translation model: one 2D offset per section. Residual for a match
  between sections a and b at points (p, q): (p + t_a) - (q + t_b). The
  normal equations form a graph Laplacian over the section graph (pairs at
  z-distance <= 3, docs/example_gen_cross:1) which is solved by
  Jacobi-preconditioned conjugate gradient on device — CG's
  matvec is a gather/scatter over match edges, batchable and shardable
  over z-blocks with psum reductions for multi-host stacks.
- affine model: 6 parameters per section, same edge structure, with a
  regularization pulling each affine toward identity (gauge fixing plus
  conditioning for weakly-connected sections).

The first section is pinned to the identity to fix the global gauge.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass
class AlignmentResult:
    group_ids: List[str]
    # per-section 2x3 affines mapping section coords -> global coords
    transforms: np.ndarray  # (Z, 2, 3)
    residual: float  # RMS match residual after alignment


def _collect_edges(matches: Sequence[dict]):
    """Flatten a Render-schema match collection into edge arrays.

    Returns (group_ids, a_idx (M,), b_idx (M,), p (M,2), q (M,2), w (M,)).
    """
    groups: Dict[str, int] = {}
    a_idx, b_idx, ps, qs, ws = [], [], [], [], []
    for rec in matches:
        ga = str(rec["pGroupId"])
        gb = str(rec["qGroupId"])
        for g in (ga, gb):
            if g not in groups:
                groups[g] = len(groups)
        m = rec["matches"]
        px, py = m["p"][0], m["p"][1]
        qx, qy = m["q"][0], m["q"][1]
        w = m["w"]
        for k in range(len(w)):
            if w[k] <= 0:
                continue  # dummy matches (src/optflow.cpp:560-569)
            a_idx.append(groups[ga])
            b_idx.append(groups[gb])
            ps.append((px[k], py[k]))
            qs.append((qx[k], qy[k]))
            ws.append(w[k])
    group_ids = [g for g, _ in sorted(groups.items(), key=lambda kv: kv[1])]
    return (
        group_ids,
        np.asarray(a_idx, np.int32),
        np.asarray(b_idx, np.int32),
        np.asarray(ps, np.float32).reshape(-1, 2),
        np.asarray(qs, np.float32).reshape(-1, 2),
        np.asarray(ws, np.float32),
    )


def _cg(matvec, b, M_inv, iters: int, tol: float):
    """Jacobi-preconditioned conjugate gradient (device-side)."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = M_inv * r0
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cond(state):
        i, x, r, p, rz = state
        return (i < iters) & (jnp.sum(r * r) > tol)

    def body(state):
        i, x, r, p, rz = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv * r
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-12)
        p = z + beta * p
        return i + 1, x, r, p, rz_new

    _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
    return x


def solve_translation_alignment(
    matches: Sequence[dict],
    iters: int = 200,
    tol: float = 1e-6,
) -> AlignmentResult:
    """Per-section translations minimizing sum w ||(p + t_a) - (q + t_b)||^2
    with t_0 = 0."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, np.zeros((z, 2, 3), np.float32), 0.0)

    a = jnp.asarray(a_idx)
    b = jnp.asarray(b_idx)
    wj = jnp.asarray(w)
    d = jnp.asarray(q - p)  # residual target: t_a - t_b = q - p per edge

    # Gauge fixing: a quadratic penalty pinning t_0 ~ 0 keeps the operator
    # symmetric positive definite (a replaced row would break CG).
    pin = 2.0 * float(np.sum(w)) + 1.0

    # Laplacian matvec: (L t)_i = sum_edges w * (t_a - t_b) contributions.
    def matvec(t):  # t: (Z, 2)
        diff = t[a] - t[b]
        out = jnp.zeros_like(t)
        out = out.at[a].add(wj[:, None] * diff)
        out = out.at[b].add(-wj[:, None] * diff)
        out = out.at[0].add(pin * t[0])
        return out

    rhs = jnp.zeros((z, 2))
    rhs = rhs.at[a].add(wj[:, None] * d)
    rhs = rhs.at[b].add(-wj[:, None] * d)

    deg = jnp.zeros((z,))
    deg = deg.at[a].add(wj)
    deg = deg.at[b].add(wj)
    deg = deg.at[0].add(pin)
    M_inv = (1.0 / jnp.maximum(deg, 1e-9))[:, None] * jnp.ones((1, 2))

    t = _cg(matvec, rhs, M_inv, iters, tol)
    t_np = np.asarray(t)

    transforms = np.tile(
        np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (z, 1, 1)
    )
    transforms[:, 0, 2] = t_np[:, 0]
    transforms[:, 1, 2] = t_np[:, 1]

    res = np.asarray((p + t_np[a_idx]) - (q + t_np[b_idx]))
    rms = float(np.sqrt((res**2).sum(axis=1).mean()))
    return AlignmentResult(group_ids, transforms, rms)


def solve_affine_alignment(
    matches: Sequence[dict],
    reg_lambda: float = 1e-3,
    iters: int = 400,
    tol: float = 1e-8,
) -> AlignmentResult:
    """Per-section affines A_z (2x3) minimizing
    sum w ||A_a(p) - A_b(q)||^2 + reg * sum ||A_z - I||^2, A_0 pinned."""
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    if z == 0 or len(w) == 0:
        ident = np.tile(
            np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (max(z, 0), 1, 1)
        )
        return AlignmentResult(group_ids, ident, 0.0)

    a = jnp.asarray(a_idx)
    b = jnp.asarray(b_idx)
    wj = jnp.asarray(w)
    pj = jnp.asarray(p)
    qj = jnp.asarray(q)

    # x: (Z, 6) = [a11, a12, tx, a21, a22, ty], stored as delta from identity
    def apply(x, pts, idx):
        A = x[idx].reshape(-1, 2, 3)
        ones = jnp.ones((pts.shape[0], 1))
        ph = jnp.concatenate([pts, ones], axis=1)  # (M, 3)
        delta = jnp.einsum(
            "mij,mj->mi", A, ph, precision=jax.lax.Precision.HIGHEST
        )
        return pts + delta

    def residuals(x):
        return apply(x, pj, a) - apply(x, qj, b)  # (M, 2)

    # Normal equations via JVP/VJP (matrix-free Gauss-Newton; the problem
    # is linear so one CG solve is exact).
    pin = 2.0 * float(np.sum(w)) + 1.0

    def matvec(x):
        _, jv = jax.jvp(residuals, (jnp.zeros((z, 6)),), (x,))
        _, vjp = jax.vjp(residuals, jnp.zeros((z, 6)))
        (jtjv,) = vjp(wj[:, None] * jv)
        out = jtjv + reg_lambda * x
        # symmetric gauge penalty pinning section 0's delta toward 0
        out = out.at[0].add(pin * x[0])
        return out

    r0 = residuals(jnp.zeros((z, 6)))
    _, vjp0 = jax.vjp(residuals, jnp.zeros((z, 6)))
    (rhs,) = vjp0(-wj[:, None] * r0)

    M_inv = jnp.ones((z, 6))
    x = _cg(matvec, rhs, M_inv, iters, tol)
    x_np = np.asarray(x).reshape(z, 2, 3)

    transforms = np.tile(
        np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (z, 1, 1)
    )
    transforms[:, :, :2] += x_np[:, :, :2]
    transforms[:, :, 2] += x_np[:, :, 2]

    res = np.asarray(residuals(jnp.asarray(x)))
    rms = float(np.sqrt((res**2).sum(axis=1).mean()))
    return AlignmentResult(group_ids, transforms, rms)
