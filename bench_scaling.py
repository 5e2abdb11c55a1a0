#!/usr/bin/env python
"""Scaling-efficiency benchmark for the sharded pair scheduler's solve.

Measures image-pairs/s of the data-parallel batched solve (shard_map over
the ``pairs`` axis, what PairScheduler dispatches) on 1, 2, 4, ... of the
visible cards with constant work per card, and reports efficiency against
linear scaling (the BASELINE.md target is >= 0.9). Runs on the GPU only.

Prints one JSON line.

Usage: python bench_scaling.py
"""

import json
import time


def measure() -> dict:
    """Pairs/s and efficiency per mesh size, in this process (the caller
    owns the cards; no second process is started)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import DX, DY, device_record, make_pair
    from optflow.core.config import TVL1Params
    from optflow.dist.mesh import make_pair_mesh
    from optflow.ops.tvl1 import tvl1_flow_batched

    n_dev = len(jax.devices())
    params = TVL1Params()  # reference defaults
    H, W = 256, 1024  # production strip
    per_dev = 16  # production device batch
    a, b = make_pair(H, W, DX, DY, seed=0)

    results = {}
    sizes = [s for s in (1, 2, 4, 8) if s <= n_dev]
    for n in sizes:
        mesh = make_pair_mesh(n_pairs_axis=n, n_rows_axis=1,
                              devices=jax.devices()[:n])
        batch = per_dev * n
        sharding = NamedSharding(mesh, P("pairs"))
        i0 = jax.device_put(np.broadcast_to(a, (batch, H, W)), sharding)
        i1 = jax.device_put(np.broadcast_to(b, (batch, H, W)), sharding)
        solve = jax.jit(
            jax.shard_map(
                lambda x, y: tvl1_flow_batched(x, y, params),
                mesh=mesh,
                in_specs=(P("pairs"), P("pairs")),
                out_specs=P("pairs"),
                check_vma=False,
            )
        )
        solve(i0, i1).block_until_ready()  # compile
        R = 3
        t0 = time.perf_counter()
        jax.block_until_ready([solve(i0, i1) for _ in range(R)])
        dt = (time.perf_counter() - t0) / R
        results[n] = batch / dt

    base = results[sizes[0]]
    effs = {str(n): results[n] / (base * n) for n in sizes}
    return {
        "metric": "pairs/s scaling efficiency (sharded pair solve)",
        "value": effs[str(sizes[-1])],
        "unit": f"fraction of linear at {sizes[-1]} cards",
        "vs_baseline": effs[str(sizes[-1])] / 0.9,
        "device": device_record(jax.devices()[0]),
        "shape_per_card": [per_dev, H, W],
        "pairs_per_s": {str(n): results[n] for n in sizes},
        "efficiency": effs,
    }


def main():
    from bench import require_gpu
    from optflow.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    require_gpu()
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
