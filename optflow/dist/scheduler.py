"""Sharded pair scheduler: data parallelism over image pairs.

The in-process equivalent of the reference's job-file sharding (5000 pairs
per file across cluster nodes, gen_cross_file_list.py:26-27): pairs of the
same shape are bucketed, padded to a multiple of the mesh's ``pairs`` axis,
batched with a leading dimension, and solved under one jit with the batch
sharded across devices. Padding lanes are masked out of the results.

The solve runs under shard_map (not GSPMD sharding annotations): each
device executes the batched solver on its local slice, with no
collectives. Dispatch is pipelined: chunk k+1's host->device transfer and
solve are issued before chunk k's results are read back, overlapping
H2D/compute/D2H across chunks.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from optflow.core.config import TVL1Params
from optflow.ops.tvl1 import tvl1_flow_batched


class PairScheduler:
    """Batches same-shape pairs and solves them data-parallel over the
    mesh's ``pairs`` axis."""

    def __init__(
        self,
        mesh: Mesh,
        params: TVL1Params = TVL1Params(),
        max_batch: Optional[int] = None,
        hbm_budget_bytes: int = 8 << 30,
    ):
        self.mesh = mesh
        self.params = params
        self.max_batch = max_batch
        self.hbm_budget_bytes = hbm_budget_bytes
        self._jitted: Dict[Tuple[int, int], object] = {}

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["pairs"]

    def _chunk_pairs(self, shape: Tuple[int, int]) -> int:
        """Pairs per dispatch: the configured cap, else what fits the
        per-device HBM budget (~40 level-state arrays per pair is a safe
        envelope for the coarse-to-fine solve + pipelining headroom)."""
        if self.max_batch is not None:
            n = self.max_batch
        else:
            per_pair = 40 * shape[0] * shape[1] * 4
            n = max(1, int(self.hbm_budget_bytes // per_pair)) * self.n_shards
            n = min(n, 256)
        return -(-n // self.n_shards) * self.n_shards

    def _solver_for(self, shape: Tuple[int, int]):
        if shape not in self._jitted:
            params = self.params

            def solve_local(i0s, i1s):
                # runs per device on its local (n/shards, H, W) slice
                return tvl1_flow_batched(i0s, i1s, params)

            sharded = jax.shard_map(
                solve_local,
                mesh=self.mesh,
                in_specs=(P("pairs"), P("pairs")),
                out_specs=P("pairs"),
                check_vma=False,  # loop carries mix replicated/varying
            )
            self._jitted[shape] = jax.jit(sharded)
        return self._jitted[shape]

    def solve_pairs(
        self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
    ) -> List[np.ndarray]:
        """Solve a list of (i0, i1) pairs; returns flows in input order.

        Pairs are grouped by shape; each group is padded up to a multiple
        of the pairs-axis size (zero frames solve to zero flow and are
        dropped). Chunk dispatches are pipelined: all chunks are enqueued
        asynchronously before any result is read back."""
        by_shape: Dict[Tuple[int, int], List[int]] = collections.defaultdict(
            list
        )
        for i, (a, b) in enumerate(pairs):
            assert a.shape == b.shape, "pair frames must share a shape"
            by_shape[a.shape].append(i)

        results: List[np.ndarray] = [None] * len(pairs)  # type: ignore
        n_sh = self.n_shards
        sharding = NamedSharding(self.mesh, P("pairs"))
        in_flight: List[Tuple[List[int], object]] = []
        for shape, idxs in by_shape.items():
            solver = self._solver_for(shape)
            chunk_size = self._chunk_pairs(shape)
            for start in range(0, len(idxs), chunk_size):
                chunk = idxs[start : start + chunk_size]
                n = len(chunk)
                padded = -(-n // n_sh) * n_sh
                i0s = np.zeros((padded,) + shape, np.float32)
                i1s = np.zeros((padded,) + shape, np.float32)
                for j, k in enumerate(chunk):
                    i0s[j] = pairs[k][0]
                    i1s[j] = pairs[k][1]
                # async enqueue; devices start while the host preps the
                # next chunk
                flows = solver(
                    jax.device_put(i0s, sharding),
                    jax.device_put(i1s, sharding),
                )
                in_flight.append((chunk, flows))

        for chunk, flows in in_flight:
            flows_np = np.asarray(flows)
            for j, k in enumerate(chunk):
                results[k] = flows_np[j]
        return results
