from optflow.core.config import (
    JobConfig,
    TVL1Params,
    cfg_get,
    load_job,
    resolve_features,
)

__all__ = ["JobConfig", "TVL1Params", "cfg_get", "load_job", "resolve_features"]
