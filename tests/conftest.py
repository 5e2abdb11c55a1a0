"""Test configuration: run everything on CPU with an 8-device virtual mesh
so multi-chip sharding paths are exercised without accelerators (the
strategy SURVEY.md §4 prescribes)."""

import os

# XLA reads this at backend init (lazy), so setting it here is early enough
# even when jax was imported before this file runs.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The tests never need a card: pin the CPU backend even where one exists.
import jax

jax.config.update("jax_platforms", "cpu")

from optflow.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_fibsem_like(rng, h, w, smooth=6):
    """Synthetic FIB-SEM-ish section: band-limited texture + low-frequency
    intensity structure, uint8 range, with a small dark 'resin' margin."""
    import scipy.ndimage as ndi

    base = rng.standard_normal((h, w))
    tex = ndi.gaussian_filter(base, smooth / 3.0)
    lowf = ndi.gaussian_filter(rng.standard_normal((h, w)), smooth * 3.0)
    im = tex * 2.0 + lowf * 4.0
    im = (im - im.min()) / (np.ptp(im) + 1e-9)
    return (20.0 + 215.0 * im).astype(np.float32)


@pytest.fixture
def fibsem_pair(rng):
    """A synthetic pair related by a known smooth flow (for EPE tests)."""
    return make_fibsem_like(rng, 96, 128)
