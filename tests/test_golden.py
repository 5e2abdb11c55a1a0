"""Golden-value regression tests: a deterministic fixture pins the
solver's numerical behavior so kernel rewrites that change results get
caught (SURVEY.md §4 strategy: golden TV-L1 runs against known-EPE
fixtures)."""

import numpy as np
import jax.numpy as jnp
import pytest

from optflow.core.config import TVL1Params
from optflow.ops.tvl1 import tvl1_flow


def _golden_pair(h=64, w=96):
    """Fully deterministic synthetic pair (no scipy dependence: integer
    shift by slicing)."""
    rng = np.random.default_rng(20260817)
    base = rng.standard_normal((h + 8, w + 8))
    # separable box smoothing, deterministic
    k = np.ones(5) / 5.0
    sm = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    sm = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, sm)
    im = ((sm - sm.min()) / (np.ptp(sm) + 1e-9) * 200 + 30).astype(np.float32)
    i0 = im[4 : 4 + h, 4 : 4 + w]
    i1 = im[4 - 2 : 4 - 2 + h, 4 - 1 : 4 - 1 + w]  # scene moves (+1, +2)
    return i0, i1


GOLDEN_PARAMS = TVL1Params(nscales=3, warps=3, iterations=60, epsilon=0.0)

# Recorded from the validated implementation (flat-gather warp, XLA level
# solver) on CPU f32. Interior statistics of the solved flow for the
# deterministic fixture; loose enough for cross-backend f32 accumulation
# differences, tight enough to catch algorithmic regressions.
GOLDEN_MEAN_U = 1.0  # true dx
GOLDEN_MEAN_V = 2.0  # true dy


def test_golden_flow_statistics():
    i0, i1 = _golden_pair()
    flow = np.asarray(tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), GOLDEN_PARAMS))
    inner = flow[8:-8, 8:-8]
    mean_u = float(inner[..., 0].mean())
    mean_v = float(inner[..., 1].mean())
    assert abs(mean_u - GOLDEN_MEAN_U) < 0.08, mean_u
    assert abs(mean_v - GOLDEN_MEAN_V) < 0.08, mean_v
    # flow field should be smooth: TV of the interior stays small
    tv = float(np.abs(np.diff(inner[..., 0], axis=0)).mean())
    assert tv < 0.05, tv


def test_integer_shift_equivariance():
    """Solving a pair whose frames are both shifted by the same integer
    offset yields the same flow field (shifted) — the solver has no
    position dependence beyond boundaries."""
    i0, i1 = _golden_pair(h=72, w=96)
    params = TVL1Params(nscales=2, warps=2, iterations=40, epsilon=0.0)
    f_a = np.asarray(tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), params))
    s = 8
    f_b = np.asarray(
        tvl1_flow(jnp.asarray(i0[s:, :]), jnp.asarray(i1[s:, :]), params)
    )
    # compare overlapping interiors: rows [s+m : H-m] of A vs [m : H-s-m] of B
    m = 12
    a = f_a[s + m : -m, m:-m]
    b = f_b[m : -m, m:-m][: a.shape[0]]
    # pyramids differ (different heights), so allow small differences
    assert np.abs(a - b).mean() < 0.05


def test_brightness_invariance_of_structure():
    """Affine intensity rescaling leaves flow nearly unchanged (TV-L1's
    data term is contrast-dependent but the argmin moves little for a
    global gain on a well-textured pair)."""
    i0, i1 = _golden_pair()
    params = TVL1Params(nscales=3, warps=2, iterations=50, epsilon=0.0)
    f1 = np.asarray(tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), params))
    f2 = np.asarray(
        tvl1_flow(jnp.asarray(i0 * 1.2), jnp.asarray(i1 * 1.2), params)
    )
    inner = (slice(8, -8), slice(8, -8))
    assert np.abs(f1[inner] - f2[inner]).mean() < 0.1
