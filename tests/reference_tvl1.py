"""Independent TV-L1 oracle for numerical-parity testing.

A self-contained NumPy/SciPy implementation of the duality-based TV-L1
optical flow algorithm, written directly from the published algorithm
specification:

  Sánchez Pérez, Meinhardt-Llopis, Facciolo,
  "TV-L1 Optical Flow Estimation", Image Processing On Line (IPOL) 3
  (2013), pp. 137-150, doi:10.5201/ipol.2013.26 — the algorithm (and
  pseudocode) that OpenCV's OpticalFlowDual_TVL1 implements, i.e. the
  solver the reference binary invokes through
  cv::cuda::OpticalFlowDual_TVL1 (reference src/optflow.cpp:516-520)
  with the tuned defaults of generate_TV_args
  (reference src/optflow.cpp:503-512).

This file deliberately shares NO code with optflow: scipy
map_coordinates does the warping (cubic spline interpolation, not the
production warp's truncated-cubic 2x2 kernel), the pyramid is rebuilt from
scratch here, and the update loop is plain NumPy. Parity between this
oracle and the JAX solver therefore checks the *algorithm and its
discretization* (forward-difference dual / backward-divergence primal,
thresholding data step, per-level warp count, pyramid rescale), not a
shared implementation. The driver's correctness target (BASELINE.md:
mean EPE <= 0.5 px vs the reference solver at its defaults) is asserted
against this oracle in test_reference_parity.py.

Notes on fidelity to the GPU solver the reference uses:
- cv::cuda::OpticalFlowDual_TVL1 does NOT run the optional median filter
  of the IPOL article / CPU implementation, so neither does this oracle.
- The CUDA solver warps I1 and its *precomputed* centered gradients by the
  current flow each warp iteration (rather than differentiating the warped
  image); the oracle follows that choice.
- Pyramid levels shrink by ``scaleStep`` per level with bilinear resize
  compounding level-to-level; flow upsampling multiplies by 1/scaleStep.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi

FLT_EPS = 1.192092896e-07


def _centered_gradient(im: np.ndarray):
    gx = np.empty_like(im)
    gx[:, 1:-1] = 0.5 * (im[:, 2:] - im[:, :-2])
    gx[:, 0] = 0.5 * (im[:, 1] - im[:, 0])
    gx[:, -1] = 0.5 * (im[:, -1] - im[:, -2])
    gy = np.empty_like(im)
    gy[1:-1, :] = 0.5 * (im[2:, :] - im[:-2, :])
    gy[0, :] = 0.5 * (im[1, :] - im[0, :])
    gy[-1, :] = 0.5 * (im[-1, :] - im[-2, :])
    return gx, gy


def _forward_gradient(u: np.ndarray):
    ux = np.zeros_like(u)
    ux[:, :-1] = u[:, 1:] - u[:, :-1]
    uy = np.zeros_like(u)
    uy[:-1, :] = u[1:, :] - u[:-1, :]
    return ux, uy


def _divergence(p1: np.ndarray, p2: np.ndarray):
    d = np.zeros_like(p1)
    d[:, 0] += p1[:, 0]
    d[:, 1:] += p1[:, 1:] - p1[:, :-1]
    d[0, :] += p2[0, :]
    d[1:, :] += p2[1:, :] - p2[:-1, :]
    return d


def _warp(im: np.ndarray, u1: np.ndarray, u2: np.ndarray, order: int = 3):
    h, w = im.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    return ndi.map_coordinates(
        im, [ys + u2, xs + u1], order=order, mode="nearest"
    ).astype(np.float32)


def _resize(im: np.ndarray, shape):
    if im.shape == tuple(shape):
        return im.astype(np.float32)
    zoom = (shape[0] / im.shape[0], shape[1] / im.shape[1])
    # bilinear, matching cv::resize INTER_LINEAR up to boundary handling
    return ndi.zoom(im, zoom, order=1, grid_mode=True, mode="nearest").astype(
        np.float32
    )


def _pyramid_shapes(h, w, nscales, scale_step, min_dim=16):
    shapes = [(h, w)]
    ch, cw = h, w
    for _ in range(1, nscales):
        nh = int(round(ch * scale_step))
        nw = int(round(cw * scale_step))
        if nh < min_dim or nw < min_dim:
            break
        shapes.append((nh, nw))
        ch, cw = nh, nw
    return shapes


def tvl1_reference(
    i0: np.ndarray,
    i1: np.ndarray,
    tau: float = 0.25,
    lambda_: float = 0.05,
    theta: float = 0.3,
    nscales: int = 10,
    warps: int = 5,
    epsilon: float = 0.01,
    iterations: int = 300,
    scale_step: float = 0.8,
) -> np.ndarray:
    """Coarse-to-fine TV-L1 flow (IPOL alg. 1-3). Returns (H, W, 2)."""
    h, w = i0.shape
    shapes = _pyramid_shapes(h, w, nscales, scale_step)
    p0 = [i0.astype(np.float32)]
    p1 = [i1.astype(np.float32)]
    for s in shapes[1:]:
        p0.append(_resize(p0[-1], s))
        p1.append(_resize(p1[-1], s))

    l_t = lambda_ * theta
    taut = tau / theta
    u1 = np.zeros(shapes[-1], np.float32)
    u2 = np.zeros(shapes[-1], np.float32)

    for s in range(len(shapes) - 1, -1, -1):
        I0, I1 = p0[s], p1[s]
        lh, lw = shapes[s]
        thresh = epsilon * epsilon * lh * lw
        I1x, I1y = _centered_gradient(I1)
        pp = [np.zeros((lh, lw), np.float32) for _ in range(4)]
        for _ in range(warps):
            i1w = _warp(I1, u1, u2)
            i1wx = _warp(I1x, u1, u2)
            i1wy = _warp(I1y, u1, u2)
            grad = i1wx * i1wx + i1wy * i1wy
            rho_c = i1w - i1wx * u1 - i1wy * u2 - I0
            for _ in range(iterations):
                rho = rho_c + i1wx * u1 + i1wy * u2
                d1 = np.where(
                    rho < -l_t * grad,
                    l_t * i1wx,
                    np.where(
                        rho > l_t * grad,
                        -l_t * i1wx,
                        np.where(
                            grad > FLT_EPS, -rho / np.maximum(grad, FLT_EPS) * i1wx, 0.0
                        ),
                    ),
                )
                d2 = np.where(
                    rho < -l_t * grad,
                    l_t * i1wy,
                    np.where(
                        rho > l_t * grad,
                        -l_t * i1wy,
                        np.where(
                            grad > FLT_EPS, -rho / np.maximum(grad, FLT_EPS) * i1wy, 0.0
                        ),
                    ),
                )
                u1n = u1 + d1 + theta * _divergence(pp[0], pp[1])
                u2n = u2 + d2 + theta * _divergence(pp[2], pp[3])
                err = float(np.sum((u1n - u1) ** 2 + (u2n - u2) ** 2))
                u1, u2 = u1n.astype(np.float32), u2n.astype(np.float32)
                u1x, u1y = _forward_gradient(u1)
                u2x, u2y = _forward_gradient(u2)
                ng1 = 1.0 + taut * np.sqrt(u1x * u1x + u1y * u1y)
                ng2 = 1.0 + taut * np.sqrt(u2x * u2x + u2y * u2y)
                pp[0] = (pp[0] + taut * u1x) / ng1
                pp[1] = (pp[1] + taut * u1y) / ng1
                pp[2] = (pp[2] + taut * u2x) / ng2
                pp[3] = (pp[3] + taut * u2y) / ng2
                if epsilon > 0 and err < thresh:
                    break
        if s > 0:
            nh, nw = shapes[s - 1]
            u1 = _resize(u1, (nh, nw)) / scale_step
            u2 = _resize(u2, (nh, nw)) / scale_step

    return np.stack([u1, u2], axis=-1)
