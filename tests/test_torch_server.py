"""The port's HTTP server on a CPU app: the two pages, ``/config``,
``/positions.bin``'s byte layout (the JAX server's), ``/control``,
``/metrics``, and ``/frame.png``, whose standard-library PNG must decode
(PIL) to exactly the app's ``render()``."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import particle3d_tpu_torch as P
from particle3d_tpu_torch.app import server
from particle3d_tpu_torch.app.driver import SimulationApp

N = 256


@pytest.fixture(scope="module")
def served():
    st, cfg, dt = P.make_scene("reference", seed=0, n=N, device="cpu")
    app = SimulationApp(st, cfg, update_rate=1.0 / dt, device="cpu")
    httpd = server.make_server(app, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield app, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(url, name, args):
    req = urllib.request.Request(
        url + "/control", method="POST",
        data=json.dumps({"name": name, "args": args}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_pages(served):
    _, url = served
    body, ctype = _get(url + "/")
    assert ctype == "text/html" and b"particle3d-tpu" in body and b"/gl" in body
    body, ctype = _get(url + "/gl")
    assert ctype == "text/html"
    assert b"webgl2" in body and b"positions.bin" in body
    with pytest.raises(urllib.error.HTTPError):
        _get(url + "/nothing")


def test_positions_bin_layout(served):
    app, url = served
    body, ctype = _get(url + "/positions.bin")
    assert ctype == "application/octet-stream"
    n = int(np.frombuffer(body[:4], np.int32)[0])
    w = float(np.frombuffer(body[4:8], np.float32)[0])
    assert n == N and w == 10.0 and len(body) == 8 + 13 * n
    pos = np.frombuffer(body[8:8 + 12 * n], np.float32).reshape(n, 3)
    spec = np.frombuffer(body[8 + 12 * n:], np.uint8)
    np.testing.assert_array_equal(pos, app.state.positions.numpy())
    np.testing.assert_array_equal(spec, app.state.species.numpy())


def test_control_config_and_metrics(served):
    app, url = served
    assert _post(url, "set_drag", {"value": 0.5}) == {"ok": True}
    assert _post(url, "keys", {"keys": ["w", "left"], "dt": 0.1})["ok"]
    assert _post(url, "set_color", {"species": 1, "rgb": "#ff8000"})["ok"]
    cfg = json.loads(_get(url + "/config")[0])
    assert cfg["coefficient"] == 0.5 and cfg["n"] == N
    assert cfg["colors"][1] == pytest.approx([1.0, 128 / 255, 0.0])
    assert set(cfg) == set(server.config_record(app))
    assert float(app.camera.yaw) == pytest.approx(-9.0)
    step0 = json.loads(_get(url + "/metrics")[0])["step_index"]
    app._accum = 1.0  # a frame's worth of time is due: the next request ticks
    _get(url + "/positions.bin")
    m = json.loads(_get(url + "/metrics")[0])
    assert m["step_index"] > step0 and m.keys() == app.metrics().keys()
    for bad in ({"name": "set_drag", "args": {}}, {"name": "explode"}):
        req = urllib.request.Request(url + "/control", method="POST",
                                     data=json.dumps(bad).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400


def test_frame_png_equals_render(served):
    app, url = served
    body, ctype = _get(url + "/frame.png?w=160&h=120")
    assert ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    want = app.render(160, 120)  # no tick in between
    assert img.shape == (120, 160, 3)
    np.testing.assert_array_equal(img, want)
    assert (want != want[0, 0]).any(-1).mean() > 0.01


def test_encode_png_round_trip():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    out = np.asarray(Image.open(io.BytesIO(server.encode_png(img))))
    np.testing.assert_array_equal(out, img)
