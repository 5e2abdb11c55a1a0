from optflow.dist.mesh import make_pair_mesh
from optflow.dist.scheduler import PairScheduler
from optflow.dist.tiled import tiled_tvl1_flow

__all__ = ["make_pair_mesh", "PairScheduler", "tiled_tvl1_flow"]
