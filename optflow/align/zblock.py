"""Z-block Schur-complement alignment solve — the long-context scaling
structure for stack alignment.

The production pair graph couples sections only at z-distance <= 3
(reference docs/example_gen_cross:1, support_scripts/
gen_cross_file_list.py:23-27), so the normal equations of the global
alignment problem are (nearly) block-banded along z. This solver exploits
that directly (SURVEY.md §2.4 "z-axis as the sequence
dimension"):

1. Sections are ordered by z and partitioned into contiguous blocks; a
   thin vertex separator per internal boundary absorbs every cross-block
   edge (any edge endpoint falling in a later block is promoted into the
   separator, so the construction is correct for arbitrary graphs, not
   just banded ones — it is merely *efficient* when the graph is banded).
2. Per-block dense normal matrices are Cholesky-factorized batched on the
   device (vmapped cho_factor over the block axis).
3. The separator (Schur) system S = A_SS - sum_k A_SI A_II^-1 A_IS is
   reduced across blocks — with a device mesh, each device owns a shard of
   blocks and the reduction is one psum over the block axis (one
   collective); the small separator solve is replicated.
4. Interiors back-substitute locally (batched cho_solve).

Unlike the edge-sharded CG solvers (align/distributed.py) this is a DIRECT
solve: one factorization, no iteration-count/conditioning concerns, and
its FLOPs are dense matmuls.

Models: ``translation`` (1 parameter per section per component) and
``affine`` (3 parameters; the x- and y-rows of a 2x3 affine share the same
per-edge coefficients (x, y, 1), so both components solve against ONE
factorization with two right-hand sides).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from optflow.align.global_solve import AlignmentResult, _collect_edges

# f32 products stay f32 (no TF32): the Schur reduction subtracts
# near-equal terms
_HI = jax.lax.Precision.HIGHEST


def _z_order(group_ids: List[str]) -> np.ndarray:
    """Stable section order by numeric group id (Render group ids are z
    values as strings) with a lexicographic fallback."""
    def key(g):
        try:
            return (0, float(g), g)
        except ValueError:
            return (1, 0.0, g)

    order = sorted(range(len(group_ids)), key=lambda i: key(group_ids[i]))
    return np.asarray(order, np.int64)


def _partition(
    zpos_a: np.ndarray,
    zpos_b: np.ndarray,
    z: int,
    block_sections: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Assign each section (by z position) a block id, then promote the
    later endpoint of every cross-block edge into the separator.

    Returns (block_of_section (Z,), is_separator (Z,) bool) in z order.
    """
    nb = max(1, -(-z // block_sections))
    block = np.minimum(np.arange(z) // block_sections, nb - 1)
    is_sep = np.zeros(z, bool)
    # iterate: promoting an endpoint can never create new cross-interior
    # edges, so one pass suffices
    cross = block[zpos_a] != block[zpos_b]
    later = np.where(zpos_a > zpos_b, zpos_a, zpos_b)
    is_sep[later[cross]] = True
    return block, is_sep


def solve_zblock_alignment(
    matches: Sequence[dict],
    model: str = "affine",
    block_sections: int = 256,
    reg_lambda: float = 1e-3,
    mesh=None,
    axis_name: str = "pairs",
) -> AlignmentResult:
    """Direct z-block Schur solve of the stack alignment problem.

    matches: Render-schema match collection (engine sink output).
    model: "translation" or "affine".
    mesh: optional jax mesh; blocks shard over ``axis_name`` and the Schur
      reduction becomes a psum (single-device without it).
    """
    group_ids, a_idx, b_idx, p, q, w = _collect_edges(matches)
    z = len(group_ids)
    ident = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (max(z, 0), 1, 1))
    if z == 0 or len(w) == 0:
        return AlignmentResult(group_ids, ident, 0.0)

    k = 1 if model == "translation" else 3
    order = _z_order(group_ids)
    rank = np.empty(z, np.int64)
    rank[order] = np.arange(z)  # section -> z position
    za = rank[a_idx]
    zb = rank[b_idx]

    block, is_sep = _partition(za, zb, z, block_sections)
    nb = int(block.max()) + 1

    # --- index maps (z-order space) -------------------------------------
    sep_ids = np.where(is_sep)[0]
    ns = len(sep_ids)
    sep_rank = np.full(z, -1, np.int64)
    sep_rank[sep_ids] = np.arange(ns)

    int_rank = np.full(z, -1, np.int64)
    int_count = np.zeros(nb, np.int64)
    for zi in range(z):
        if not is_sep[zi]:
            bblk = block[zi]
            int_rank[zi] = int_count[bblk]
            int_count[bblk] += 1
    ki = int(int_count.max()) if nb > 0 else 0  # padded interior size

    # --- per-edge coefficient rows ---------------------------------------
    m = len(w)
    if model == "translation":
        ca = np.ones((m, 1), np.float32)
        cb = np.ones((m, 1), np.float32)
        d = (q - p).astype(np.float32)  # rhs target per edge (2 comps)
    else:
        ca = np.concatenate([p, np.ones((m, 1), np.float32)], axis=1)
        cb = np.concatenate([q, np.ones((m, 1), np.float32)], axis=1)
        d = (q - p).astype(np.float32)

    # --- dense assembly (host; O(edges * k^2), tiny next to the solve) ---
    ni = ki * k
    nss = ns * k
    A_II = np.zeros((nb, ni, ni), np.float64)
    A_IS = np.zeros((nb, ni, nss), np.float64)
    A_SS = np.zeros((nss, nss), np.float64)
    r_I = np.zeros((nb, ni, 2), np.float64)
    r_S = np.zeros((nss, 2), np.float64)

    def slot(zi):
        """(kind, block, offset): kind 0 interior, 1 separator."""
        if is_sep[zi]:
            return 1, -1, sep_rank[zi] * k
        return 0, int(block[zi]), int_rank[zi] * k

    for e in range(m):
        we = float(w[e])
        rows = [(za[e], ca[e], 1.0), (zb[e], cb[e], -1.0)]
        des = d[e]
        for (zi, ci, si) in rows:
            kind_i, blk_i, off_i = slot(zi)
            gi = we * si * ci  # (k,)
            # rhs: J^T W d
            tgt = r_S[off_i : off_i + k] if kind_i else r_I[blk_i, off_i : off_i + k]
            tgt += np.outer(gi, des)
            for (zj, cj, sj) in rows:
                kind_j, blk_j, off_j = slot(zj)
                gij = we * si * sj * np.outer(ci, cj)  # (k, k)
                if kind_i == 0 and kind_j == 0:
                    A_II[blk_i, off_i : off_i + k, off_j : off_j + k] += gij
                elif kind_i == 0 and kind_j == 1:
                    A_IS[blk_i, off_i : off_i + k, off_j : off_j + k] += gij
                elif kind_i == 1 and kind_j == 1:
                    A_SS[off_i : off_i + k, off_j : off_j + k] += gij
                # (1, 0) is the transpose of (0, 1); filled implicitly by
                # using A_IS^T in the Schur product

    # regularization + gauge pin + identity rows for padded slots
    pin = 2.0 * float(np.sum(w)) + 1.0
    reg = reg_lambda if model == "affine" else 1e-9
    for bblk in range(nb):
        for j in range(ni):
            sec_used = j < int_count[bblk] * k
            A_II[bblk, j, j] += reg if sec_used else 1.0
    A_SS[np.arange(nss), np.arange(nss)] += reg
    # gauge: pin section 0 (original index) wherever it landed in z order
    kind0, blk0, off0 = slot(int(rank[0]))
    for j in range(k):
        if kind0:
            A_SS[off0 + j, off0 + j] += pin
        else:
            A_II[blk0, off0 + j, off0 + j] += pin

    # --- device solve ------------------------------------------------------
    x_I_np, x_S_np = _schur_solve(
        A_II, A_IS, A_SS, r_I, r_S, mesh, axis_name
    )

    # --- scatter back to (Z, 2, 3) transforms ------------------------------
    transforms = ident.copy()
    delta = np.zeros((z, 2, k), np.float32)
    for zi in range(z):
        kind_i, blk_i, off_i = slot(zi)
        sec = order[zi]
        src = x_S_np[off_i : off_i + k] if kind_i else x_I_np[blk_i, off_i : off_i + k]
        delta[sec] = src.T  # (k, 2) -> (2, k)
    if model == "translation":
        transforms[:, 0, 2] += delta[:, 0, 0]
        transforms[:, 1, 2] += delta[:, 1, 0]
    else:
        transforms[:, :, :2] += delta[:, :, :2]
        transforms[:, :, 2] += delta[:, :, 2]

    ph_p = np.concatenate([p, np.ones((m, 1), np.float32)], axis=1)
    ph_q = np.concatenate([q, np.ones((m, 1), np.float32)], axis=1)
    res = np.einsum("mij,mj->mi", transforms[a_idx], ph_p) - np.einsum(
        "mij,mj->mi", transforms[b_idx], ph_q
    )
    rms = float(np.sqrt((res**2).sum(axis=1).mean()))
    return AlignmentResult(group_ids, transforms, rms)


def _schur_solve(A_II, A_IS, A_SS, r_I, r_S, mesh, axis_name):
    """Batched block Cholesky + Schur reduction + back-substitution.

    Single device: one vmapped factorization. With a mesh: blocks shard
    over ``axis_name``, Schur contributions psum, the reduced separator
    solve is replicated, back-substitution is local.
    """
    nb = A_II.shape[0]
    nss = A_SS.shape[1]

    def local(a_ii, a_is, r_i):
        cf = jax.vmap(lambda a: jax.scipy.linalg.cho_factor(a)[0])(a_ii)
        # X = A_II^-1 [A_IS | r_I]
        rhs = jnp.concatenate([a_is, r_i], axis=2)
        X = jax.vmap(lambda c, b: jax.scipy.linalg.cho_solve((c, False), b))(
            cf, rhs
        )
        X_ais = X[:, :, :nss]
        X_ri = X[:, :, nss:]
        # sum_k A_SI A_II^-1 A_IS
        s_con = jnp.einsum("bij,bik->jk", a_is, X_ais, precision=_HI)
        r_con = jnp.einsum("bij,bik->jk", a_is, X_ri, precision=_HI)
        return cf, s_con, r_con

    if mesh is None or nb == 0:
        a_ii = jnp.asarray(A_II)
        a_is = jnp.asarray(A_IS)
        r_i = jnp.asarray(r_I)
        cf, s_con, r_con = local(a_ii, a_is, r_i)
        S_red = jnp.asarray(A_SS) - s_con
        rhs_red = jnp.asarray(r_S) - r_con
        x_S = jax.scipy.linalg.solve(S_red, rhs_red, assume_a="pos")
        bsub = jnp.asarray(r_I) - jnp.einsum(
            "bij,jc->bic", a_is, x_S, precision=_HI
        )
        x_I = jax.vmap(lambda c, b: jax.scipy.linalg.cho_solve((c, False), b))(
            cf, bsub
        )
        return np.asarray(x_I), np.asarray(x_S)

    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = mesh.shape[axis_name]
    nb_pad = -(-nb // n_shards) * n_shards
    eye_pad = np.tile(np.eye(A_II.shape[1]), (nb_pad - nb, 1, 1))
    A_II_p = np.concatenate([A_II, eye_pad], axis=0) if nb_pad > nb else A_II
    A_IS_p = np.concatenate(
        [A_IS, np.zeros((nb_pad - nb,) + A_IS.shape[1:])], axis=0
    ) if nb_pad > nb else A_IS
    r_I_p = np.concatenate(
        [r_I, np.zeros((nb_pad - nb,) + r_I.shape[1:])], axis=0
    ) if nb_pad > nb else r_I

    def shard_fn(a_ii, a_is, r_i, a_ss, r_s):
        cf, s_con, r_con = local(a_ii, a_is, r_i)
        S_red = a_ss - jax.lax.psum(s_con, axis_name)
        rhs_red = r_s - jax.lax.psum(r_con, axis_name)
        x_S = jax.scipy.linalg.solve(S_red, rhs_red, assume_a="pos")
        bsub = r_i - jnp.einsum("bij,jc->bic", a_is, x_S, precision=_HI)
        x_I = jax.vmap(lambda c, b: jax.scipy.linalg.cho_solve((c, False), b))(
            cf, bsub
        )
        return x_I, x_S

    spec_b = P(axis_name)
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_b, spec_b, spec_b, P(), P()),
        out_specs=(spec_b, P()),
        check_vma=False,
    )
    shard_in = NamedSharding(mesh, spec_b)
    x_I, x_S = fn(
        jax.device_put(jnp.asarray(A_II_p), shard_in),
        jax.device_put(jnp.asarray(A_IS_p), shard_in),
        jax.device_put(jnp.asarray(r_I_p), shard_in),
        jnp.asarray(A_SS),
        jnp.asarray(r_S),
    )
    return np.asarray(x_I)[:nb], np.asarray(x_S)
