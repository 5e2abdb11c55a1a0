"""Offline map-to-matches conversion — the replayable upload path.

Reimplements support_scripts/upload_matches.py without renderapi: reads
the ``_x.tiff``/``_y.tiff`` maps the engine (or the reference binary)
wrote and converts them to Render point matches. Two modes, matching the
reference's globs:

- strip mode (``*_bottom_x.tiff``): samples n random pixels per top/bottom
  strip; bottom-strip rows are offset by ``scale * maxY - strip_height``
  using the tilespec geometry (upload_matches.py:17-52)
- full-map mode (``*[0-9]_x.tiff``): samples 2n points restricted to
  150-px top and bottom bands and recenters for differing tile sizes via
  ``(tile_0 - tile_1) // 2 * scale`` (upload_matches.py:54-90)

Filename convention parsed: ``{pGroup}_{qGroup}~{pTile}~{qTile}_{scale}``.
Tile sizes come from a local JSON tilespec ({tileId: {maxX, maxY}}).
Matches go to any sink (JSONL by default; render-ws HTTP with --host);
groups already present in an existing JSONL store are skipped, preserving
the reference's idempotent re-run behavior (upload_matches.py:26-27).
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Dict, Optional, Set, Tuple

import numpy as np

from optflow.core.imgio import read_float_tiff
from optflow.sinks.http import RenderHttpSink
from optflow.sinks.store import JsonlMatchSink, MatchSink


def _parse_base(base: str) -> Optional[Tuple[list, list]]:
    """base (no scale suffix) -> (groups [p, q], tiles [pTile, qTile]).

    Returns None for files not following the ``{pG}_{qG}~{pT}~{qT}``
    convention (e.g. maps written from gen_pairs-style ``pId_qId`` output
    names, which carry no group information to upload)."""
    name = base.split("/")[-1]
    parts = name.split("~")
    if len(parts) < 3:
        print(f"skipping {name}: not in group~tile~tile form")
        return None
    groups = parts[0].split("_")
    tiles = parts[1:]
    if len(groups) < 2:
        print(f"skipping {name}: missing group ids")
        return None
    return groups, tiles


def _match_record(p, q, w, groups, tiles) -> dict:
    return {
        "pGroupId": groups[0],
        "qGroupId": groups[1],
        "pId": tiles[0],
        "qId": tiles[1],
        "matches": {
            "p": np.asarray(p).T.tolist(),
            "q": np.asarray(q).T.tolist(),
            "w": list(w),
        },
    }


def gen_matches(
    flow_dir: str,
    sink: MatchSink,
    n: int = 25,
    tile_sizes: Optional[Dict[str, dict]] = None,
    existing_groups: Optional[Set[Tuple[str, str]]] = None,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Convert all maps in flow_dir to matches; returns records written."""
    if rng is None:
        rng = np.random.default_rng()
    tile_sizes = tile_sizes or {}
    existing_groups = existing_groups or set()
    written = 0

    # ---- strip mode: paired *_top/_bottom maps
    for path in sorted(glob(f"{flow_dir}/*_bottom_x.tiff")):
        base = path[: -len("_bottom_x.tiff")]
        scale = float(base.split("_")[-1])
        inv_scale = 1.0 / scale
        base = "_".join(base.split("_")[:-1])
        parsed = _parse_base(base)
        if parsed is None:
            continue
        groups, tiles = parsed
        if (groups[0], groups[1]) in existing_groups:
            continue
        p, q, w = [], [], []
        for s in ("top", "bottom"):
            im_x = read_float_tiff(f"{base}_{scale:.2f}_{s}_x.tiff")
            im_y = read_float_tiff(f"{base}_{scale:.2f}_{s}_y.tiff")
            rand = (rng.random((n, 2)) * im_x.shape).astype(int)
            w += [1.0] * n
            dx = np.array([im_x[tuple(j)] for j in rand])
            dy = np.array([im_y[tuple(j)] for j in rand])
            randf = rand.astype(float)
            if s == "bottom" and tiles[0] in tile_sizes:
                max_y = float(tile_sizes[tiles[0]].get("maxY", 0))
                randf[:, 0] += scale * max_y - im_x.shape[0]
            p += (inv_scale * randf[:, [1, 0]]).tolist()
            randf = randf.copy()
            randf[:, 1] += dx
            randf[:, 0] += dy
            q += (inv_scale * randf[:, [1, 0]]).tolist()
        sink.put([_match_record(p, q, w, groups, tiles)])
        written += 1

    # ---- full-map mode
    for path in sorted(glob(f"{flow_dir}/*[0-9]_x.tiff")):
        base = path[: -len("_x.tiff")]
        scale = float(base.split("_")[-1])
        inv_scale = 1.0 / scale
        base = "_".join(base.split("_")[:-1])
        parsed = _parse_base(base)
        if parsed is None:
            continue
        groups, tiles = parsed
        if (groups[0], groups[1]) in existing_groups:
            continue
        im_x = read_float_tiff(f"{base}_{scale:.2f}_x.tiff")
        im_y = read_float_tiff(f"{base}_{scale:.2f}_y.tiff")
        band = min(150, im_x.shape[0])
        rand = rng.random((2 * n, 2))
        rand[:, 1] *= im_x.shape[1]
        rand[:, 0] *= band
        rand[n:, 0] += im_x.shape[0] - band
        rand = rand.astype(int)
        w = [1.0] * (2 * n)
        if len(tiles) >= 2 and tiles[0] in tile_sizes and tiles[1] in tile_sizes:
            t0x = float(tile_sizes[tiles[0]].get("maxX", 0))
            t1x = float(tile_sizes[tiles[1]].get("maxX", 0))
            t0y = float(tile_sizes[tiles[0]].get("maxY", 0))
            t1y = float(tile_sizes[tiles[1]].get("maxY", 0))
            im_x = im_x - (t0x - t1x) // 2 * scale
            im_y = im_y - (t0y - t1y) // 2 * scale
        dx = np.array([im_x[tuple(j)] for j in rand])
        dy = np.array([im_y[tuple(j)] for j in rand])
        randf = rand.astype(float)
        p = (inv_scale * randf[:, [1, 0]]).copy().tolist()
        randf[:, 1] += dx
        randf[:, 0] += dy
        q = (inv_scale * randf[:, [1, 0]]).copy().tolist()
        sink.put([_match_record(p, q, w, groups, tiles)])
        written += 1
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert flow/map TIFFs to point matches"
    )
    parser.add_argument("flow_dir")
    parser.add_argument("match", help="match collection name")
    parser.add_argument("--n", default=25, type=int)
    parser.add_argument("--tile-sizes", default=None,
                        help="JSON {tileId: {maxX, maxY}}")
    parser.add_argument("--stack", default=None,
                        help="Render stack: pull tile geometry live from "
                             "render-ws (requires --host)")
    parser.add_argument("--project",
                        default=os.environ.get("RENDER_PROJECT", "default"))
    parser.add_argument("--out", default=None,
                        help="JSONL output path (default <match>.jsonl)")
    parser.add_argument("--host", default=os.environ.get("RENDER_HOST"))
    parser.add_argument("--port", default=os.environ.get("RENDER_PORT"))
    parser.add_argument("--owner", default=os.environ.get("RENDER_OWNER"))
    ns = parser.parse_args(argv)

    tile_sizes = None
    client = None
    if ns.tile_sizes:
        with open(ns.tile_sizes) as f:
            tile_sizes = json.load(f)
    elif ns.stack and ns.host:
        from optflow.sinks.render_client import RenderClient

        client = RenderClient(
            ns.host, ns.port or "8080", ns.owner or "flyem", ns.project
        )
        tile_sizes = client.tile_sizes(ns.stack)

    existing: Set[Tuple[str, str]] = set()
    if ns.host:
        sink: MatchSink = RenderHttpSink(
            host=ns.host,
            port=ns.port or "8080",
            owner=ns.owner or "flyem",
            match_collection=ns.match,
        )
        if client is not None:
            # idempotent re-runs against the live collection: probe the
            # group pairs present in flow_dir (upload_matches.py:26-27)
            pairs = set()
            for path in glob(f"{ns.flow_dir}/*_x.tiff"):
                base = "_".join(path[: -len("_x.tiff")].split("_")[:-1])
                parsed = _parse_base(base)
                if parsed:
                    pairs.add((parsed[0][0], parsed[0][1]))
            existing = client.existing_groups(ns.match, sorted(pairs))
    else:
        out = ns.out or f"{ns.match}.jsonl"
        jsink = JsonlMatchSink(out)
        for rec in jsink.read_all():
            existing.add((str(rec["pGroupId"]), str(rec["qGroupId"])))
        sink = jsink

    n = gen_matches(
        ns.flow_dir, sink, n=ns.n, tile_sizes=tile_sizes,
        existing_groups=existing,
    )
    print(f"wrote {n} match records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
