from optflow.utils.metrics import StageTimer

__all__ = ["StageTimer"]
