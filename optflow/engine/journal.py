"""Per-pair progress journal for resumable jobs.

The reference has no in-process checkpointing: a failed job is rerun from
scratch, and any match batch that wasn't HTTP-flushed is lost
(src/optflow.cpp:635-638; SURVEY.md §5). The journal records pair
completions and sink flushes so a rerun skips finished work:

- map/flow outputs: a recorded pair's TIFFs are on disk — skip it.
- random_points output: matches only survive once flushed to the sink, so
  only pairs recorded at or before the last flush event are skipped; the
  tail since the last flush is re-solved (delivery is at-least-once, and
  the JSONL/render sinks tolerate duplicates the same way the reference's
  re-runs do).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Mapping, Optional, Set


def pair_key(im_args: Dict, args: Optional[Mapping] = None) -> str:
    """Journal identity of one pair's work.

    Includes the resolved scale and a hash of the effective TV-L1
    parameters: rerunning a job against the same journal after changing
    solver params or scale must NOT silently skip pairs — their recorded
    results were produced by a different solve.
    """
    base = "|".join(
        str(im_args.get(k, "")) for k in ("p", "q", "output_name")
    )
    if args is None:
        return base
    from optflow.core.config import TVL1Params, cfg_get

    scale = cfg_get(im_args, args, "scale", 0.5)
    params = TVL1Params.from_config(im_args, args)
    sig = hashlib.sha1(
        (repr(params) + f"|scale={float(scale):.6g}").encode()
    ).hexdigest()[:10]
    return f"{base}|{sig}"


def pair_key_aliases(im_args: Dict, args: Optional[Mapping] = None) -> tuple:
    """All journal keys under which this pair's work may be recorded.

    First entry is the CURRENT key (what new completions are recorded as).
    Early journals predate the params/scale signature and recorded the bare
    ``p|q|output_name`` key; that legacy key is accepted as an alias only
    when the effective params equal the historical defaults (the only
    params legacy entries could have been produced under without the job
    file saying otherwise) — so upgrading the framework never re-solves a
    default-params job, while a params change still invalidates everything.
    """
    key = pair_key(im_args, args)
    if args is None:
        return (key,)
    from optflow.core.config import TVL1Params, cfg_get

    scale = cfg_get(im_args, args, "scale", 0.5)
    params = TVL1Params.from_config(im_args, args)
    if params == TVL1Params() and float(scale) == 0.5:
        return (key, pair_key(im_args))
    return (key,)


class JobJournal:
    def __init__(self, path: str):
        self.path = path
        self._events = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._events.append(json.loads(line))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def completed_keys(self, output_type: str) -> Set[str]:
        if output_type == "random_points":
            # only pairs covered by a flush are durable
            flushed: Set[str] = set()
            pending: list = []
            for ev in self._events:
                if ev.get("event") == "pair":
                    pending.append(ev["key"])
                elif ev.get("event") == "flush":
                    flushed.update(pending)
                    pending = []
            return flushed
        return {
            ev["key"] for ev in self._events if ev.get("event") == "pair"
        }

    def record_pair(self, key: str) -> None:
        self._write({"event": "pair", "key": key})

    def record_flush(self) -> None:
        self._write({"event": "flush"})

    def _write(self, ev: Dict) -> None:
        self._f.write(json.dumps(ev) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
