"""Device-mesh construction for distributed solves.

The reference has no in-process distribution: it scales by sharding the
pair list into job files run as independent cluster containers
(support_scripts/gen_cross_file_list.py:26-27, singularity/janelia_run.sh).
Here distribution is first-class: a jax.sharding.Mesh with

- a ``pairs`` axis — data parallelism over image pairs (the reference's
  inter-job parallelism, brought in-process), and
- a ``rows`` axis — spatial partitioning of large sections with halo
  exchange (capability the reference lacks; it downscales instead).

On several hosts, initialize with jax.distributed.initialize() before
building the mesh; the same code then spans hosts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def make_pair_mesh(
    n_pairs_axis: Optional[int] = None,
    n_rows_axis: int = 1,
    devices=None,
) -> Mesh:
    """Build a (pairs, rows) mesh over the available devices.

    Default: all devices on the pairs axis (pure data parallelism, the
    production-relevant layout for strip ROI jobs).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_pairs_axis is None:
        n_pairs_axis = n // n_rows_axis
    assert n_pairs_axis * n_rows_axis <= n, (
        f"mesh {n_pairs_axis}x{n_rows_axis} needs more than {n} devices"
    )
    grid = np.asarray(devices[: n_pairs_axis * n_rows_axis]).reshape(
        n_pairs_axis, n_rows_axis
    )
    return Mesh(grid, axis_names=("pairs", "rows"))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join a multi-host job. No-op when single-host
    arguments are absent and the environment provides no cluster config."""
    if coordinator_address is None and num_processes is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
