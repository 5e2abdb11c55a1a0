from optflow.sinks.store import JsonlMatchSink, MatchSink, NullMatchSink
from optflow.sinks.http import RenderHttpSink, make_sink

__all__ = [
    "MatchSink",
    "JsonlMatchSink",
    "NullMatchSink",
    "RenderHttpSink",
    "make_sink",
]
