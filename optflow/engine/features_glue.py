"""Bridge from the pair engine to the feature pre-alignment module.

The engine's ``aligner`` contract mirrors find_alignment
(src/features.cpp:46): aligner(frame1, frame0, im_args, args) -> 2x3
affine mapping frame1 coordinates into frame0 space, falling back to
identity when alignment is unavailable or fails its sanity gates.
"""

from __future__ import annotations

import sys

import numpy as np

from optflow.engine.pair import IDENTITY_AFFINE


def default_aligner(frame1, frame0, im_args, args) -> np.ndarray:
    try:
        from optflow.features.align import find_alignment
    except ImportError:
        print(
            "feature module unavailable; using identity pre-alignment",
            file=sys.stderr,
        )
        return IDENTITY_AFFINE
    return find_alignment(frame1, frame0, im_args, args)
