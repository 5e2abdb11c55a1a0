"""optflow — dense optical-flow and section-alignment engine in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of
janelia-cosem/fibsem-optflow (the reference; paths below are in its tree):

- coarse-to-fine TV-L1 dense optical flow (ref: src/optflow.cpp:500-520 wraps
  cv::cuda::OpticalFlowDual_TVL1; here the whole solver is JAX compiled by XLA)
- feature detect + match + RANSAC homography pre-alignment
  (ref: src/features.cpp:46-167)
- ROI-restricted solves, map/flow/random_points outputs
  (ref: src/optflow.cpp:228-261,312-496)
- point-match sampling + render-ws compatible match sinks
  (ref: src/optflow.cpp:522-641)
- job-file config system with per-image -> global -> default precedence
  (ref: docs/example.json, src/optflow.cpp:92,503-512)
- distributed pair scheduling + tiled large-section solves over a
  jax.sharding.Mesh (new capability; reference scales by cluster job files,
  support_scripts/gen_cross_file_list.py:26-27)
"""

__version__ = "0.1.0"

from optflow.core.config import JobConfig, TVL1Params, cfg_get, load_job
from optflow.ops.tvl1 import tvl1_flow

__all__ = [
    "JobConfig",
    "TVL1Params",
    "cfg_get",
    "load_job",
    "tvl1_flow",
    "__version__",
]
