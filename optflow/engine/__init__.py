from optflow.engine.rois import Roi, get_rois, roi_from_array
from optflow.engine.pair import solve_rois
from optflow.engine.runner import run_job

__all__ = ["Roi", "get_rois", "roi_from_array", "solve_rois", "run_job"]
