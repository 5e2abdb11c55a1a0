"""Matmul-based keypoint patch extraction and in-patch sampling.

The descriptor stages need image values at thousands of per-keypoint
sub-pixel locations (SURF's rotated 20x20 sigma-grid, ORB's rotated BRIEF
test pairs, the FAST intensity-centroid disk — the work
cv::cuda::SURF_CUDA / cv::cuda::ORB do on GPU, src/features.cpp:58-92).
Here the per-keypoint gathers are formulated as matmuls.

1. **Patch extraction** — for each keypoint k, a sigma-normalized
   (P x P) patch ``patch[k, p, q] = I(y_k + s_k*step*(p-c),
   x_k + s_k*step*(q-c))`` is a pair of contractions against hat-function
   weight matrices (each row has <=2 nonzeros — bilinear interpolation as
   a sparse matrix, executed dense):

       rows    = W_y[k,p,h] @ I[h,w]      (one big (K*P, H) x (H, C*W))
       patches = rows[k,p,w] @ W_x[k,q,w]^T  (K batched small matmuls)

2. **In-patch sampling** — arbitrary rotated/scaled sample positions
   (px, py) inside the patch are again bilinear hats, contracted as a
   matmul: ``val[k,s] = hy[k,s,p] @ patch[k,p,q] * hx[k,s,q]``.

Both stages run in bfloat16 with float32 accumulation (descriptors are
L2-normalized / sign-compared downstream, so the ~3-decimal-digit weight
precision is far inside their robustness margin), and keypoints are
processed in fixed-size chunks so the (K, P, C, W) row intermediate stays
small in device memory even under a vmap over pairs.

Border semantics match ops.warp.bilinear_sample: clamp-to-edge (positions
are clipped before the hat weights are built, so an out-of-image tap
lands with full weight on the border row/column).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Keypoint-chunk size for the extraction scan: bounds the row intermediate
# to chunk*P*C*W elements regardless of detector capacity.
_K_CHUNK = 512


def _hat_weights(pos: jnp.ndarray, n: int, dtype) -> jnp.ndarray:
    """(..., n) bilinear hat weights for sample positions ``pos`` (...,)
    against a length-``n`` axis, clamp-to-edge."""
    pos = jnp.clip(pos, 0.0, float(n - 1))
    idx = jax.lax.broadcasted_iota(jnp.float32, (1, n), 1).reshape(n)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(idx - pos[..., None]))
    return w.astype(dtype)


def extract_patches(
    ims: jnp.ndarray,  # (C, H, W) float — shared sampling fields
    x: jnp.ndarray,  # (K,) keypoint centers
    y: jnp.ndarray,  # (K,)
    sigma: jnp.ndarray,  # (K,) per-keypoint scale
    patch: int,  # P — patch side
    step: float,  # grid spacing in sigma units
    dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """(C, K, P, P) sigma-normalized patches, bilinearly resampled from
    ``ims`` entirely by matmuls (no gathers)."""
    c, h, w = ims.shape
    k = x.shape[0]
    p = patch
    centers = (jnp.arange(p, dtype=jnp.float32) - (p - 1) / 2.0) * step
    # pad K to a chunk multiple; padded keypoints extract garbage that is
    # masked out by the caller's validity mask
    kp = -(-k // _K_CHUNK) * _K_CHUNK
    pad = kp - k
    xp = jnp.pad(x.astype(jnp.float32), (0, pad))
    yp = jnp.pad(y.astype(jnp.float32), (0, pad))
    sp = jnp.pad(sigma.astype(jnp.float32), (0, pad))

    # Contract the LARGER image axis first: the first contraction's
    # output is the big intermediate (kc*P x C*<other axis>), so folding
    # the long axis away first shrinks it by long/short (4x at the
    # production 256x1024 strips — measured as the describe stage's
    # dominant HBM traffic, r5).
    w_first = w >= h
    if w_first:
        # (C, H, W) flattened (c, h)-major — matches the (kc, p, c, h)
        # unpack of the first contraction's output
        ims_t = ims.astype(dtype).reshape(c * h, w)
    else:
        ims_t = ims.astype(dtype).transpose(1, 0, 2).reshape(h, c * w)

    def chunk(carry, inp):
        cx, cy, cs = inp  # (_K_CHUNK,) each
        pos_y = cy[:, None] + cs[:, None] * centers[None, :]  # (kc, P)
        pos_x = cx[:, None] + cs[:, None] * centers[None, :]
        wy = _hat_weights(pos_y, h, dtype)  # (kc, P, H)
        wx = _hat_weights(pos_x, w, dtype)  # (kc, Q, W)
        if w_first:
            cols = jax.lax.dot_general(
                wx.reshape(_K_CHUNK * p, w),
                ims_t,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # (kc*Q, C*H)
            cols = cols.reshape(_K_CHUNK, p, c, h).astype(dtype)
            # (kc, Q, C, H) x (kc, P, H) -> (kc, Q, C, P)
            pat = jax.lax.dot_general(
                cols,
                wy,
                dimension_numbers=(((3,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )
            return carry, pat.transpose(0, 2, 3, 1)  # (kc, C, P, Q)
        rows = jax.lax.dot_general(
            wy.reshape(_K_CHUNK * p, h),
            ims_t,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (kc*P, C*W)
        rows = rows.reshape(_K_CHUNK, p, c, w).astype(dtype)
        # batched over keypoints, contracting w in place — no transpose of
        # the large row intermediate: (kc, P, C, W) x (kc, Q, W) -> (kc, P, C, Q)
        pat = jax.lax.dot_general(
            rows,
            wx,
            dimension_numbers=(((3,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # (kc, P, C, Q)
        return carry, pat.transpose(0, 2, 1, 3)  # (kc, C, P, Q)

    _, pats = jax.lax.scan(
        chunk,
        None,
        (
            xp.reshape(-1, _K_CHUNK),
            yp.reshape(-1, _K_CHUNK),
            sp.reshape(-1, _K_CHUNK),
        ),
    )  # (kp//chunk, chunk, C, P, P)
    pats = pats.reshape(kp, c, p, p)[:k]
    return pats.transpose(1, 0, 2, 3)  # (C, K, P, P)


def sample_patches(
    patches: jnp.ndarray,  # (K, P, P) float32
    px: jnp.ndarray,  # (K, S) in-patch x coords
    py: jnp.ndarray,  # (K, S)
    dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """(K, S) bilinear samples of each keypoint's patch at its own sample
    positions — hats contracted by matmul, clamp-to-edge at patch rim."""
    p = patches.shape[-1]
    hy = _hat_weights(py, p, dtype)  # (K, S, P)
    hx = _hat_weights(px, p, dtype)  # (K, S, P)
    t = jax.lax.dot_general(
        hy,
        patches.astype(dtype),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # (K, S, P)
    return jnp.sum(t * hx.astype(jnp.float32), axis=-1)
