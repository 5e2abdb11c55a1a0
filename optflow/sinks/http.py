"""Render web-service HTTP match sink.

Reimplements the reference's curl uploader (src/optflow.cpp:595-641):
PUT {host}:{port}/render-ws/v1/owner/{owner}/matchCollection/{mc}/matches
with JSON headers and a 10 s connect timeout, using the same config keys
and defaults (owner "flyem", matchCollection "forgetful_owner", host
10.40.3.162, port 8080). Improvement over the reference (which loses the
batch on failure, src/optflow.cpp:635-638): bounded retries with backoff
and an optional spill-to-disk fallback.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request
from typing import List, Mapping, Optional

from optflow.sinks.store import JsonlMatchSink, MatchSink, NullMatchSink


class RenderHttpSink:
    def __init__(
        self,
        host: str = "10.40.3.162",
        port: str = "8080",
        owner: str = "flyem",
        match_collection: str = "forgetful_owner",
        *,
        connect_timeout: float = 10.0,
        retries: int = 3,
        backoff: float = 1.0,
        debug: bool = False,
        spill: Optional[JsonlMatchSink] = None,
    ):
        self.url = (
            f"http://{host}:{port}/render-ws/v1/owner/{owner}"
            f"/matchCollection/{match_collection}/matches"
        )
        self.connect_timeout = connect_timeout
        self.retries = retries
        self.backoff = backoff
        self.debug = debug
        self.spill = spill

    def put(self, matches: List[dict]) -> bool:
        payload = json.dumps(matches).encode("utf-8")
        if self.debug:
            print(payload.decode("utf-8"))
            print(self.url)
        req = urllib.request.Request(
            self.url,
            data=payload,
            method="PUT",
            headers={
                "Content-Type": "application/json",
                "Accept": "application/json",
            },
        )
        delay = self.backoff
        for attempt in range(self.retries):
            try:
                with urllib.request.urlopen(
                    req, timeout=self.connect_timeout
                ) as resp:
                    resp.read()
                return True
            except (urllib.error.URLError, OSError) as e:
                print(
                    f"match upload failed (attempt {attempt + 1}/"
                    f"{self.retries}): {e}\nHostname: {self.url}",
                    file=sys.stderr,
                )
                if attempt + 1 < self.retries:
                    time.sleep(delay)
                    delay *= 2
        if self.spill is not None:
            print(
                f"spilling {len(matches)} match sets to {self.spill.path}",
                file=sys.stderr,
            )
            return self.spill.put(matches)
        return False


def make_sink(args: Mapping) -> MatchSink:
    """Build the sink a job file asks for.

    New job keys (absent in the reference, which always PUTs to render-ws):
    - ``match_sink``: "http" (default, reference behavior), "jsonl", "null"
    - ``match_output``: path for the jsonl sink / http spill file
    """
    kind = str(args.get("match_sink", "http"))
    out = args.get("match_output")
    if kind == "null":
        return NullMatchSink()
    if kind == "jsonl":
        return JsonlMatchSink(out or "matches.jsonl")
    spill = JsonlMatchSink(out) if out else None
    return RenderHttpSink(
        host=str(args.get("host", "10.40.3.162")),
        port=str(args.get("port", "8080")),
        owner=str(args.get("owner", "flyem")),
        match_collection=str(args.get("matchCollection", "forgetful_owner")),
        debug=bool(args.get("debug", False)),
        spill=spill,
    )
