from optflow.ops.warp import (
    affine_warp,
    bilinear_sample,
    centered_gradient,
    divergence,
    forward_gradient,
    warp_backward,
)
from optflow.ops.pyramid import build_pyramid, pyramid_shapes, resize_bilinear
from optflow.ops.tvl1 import tvl1_flow, tvl1_flow_level

__all__ = [
    "affine_warp",
    "bilinear_sample",
    "centered_gradient",
    "divergence",
    "forward_gradient",
    "warp_backward",
    "build_pyramid",
    "pyramid_shapes",
    "resize_bilinear",
    "tvl1_flow",
    "tvl1_flow_level",
]
