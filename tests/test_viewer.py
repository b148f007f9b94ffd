"""Live web viewer: serves page, frames, state; toggle works."""

import json
import urllib.request

import numpy as np

from nerf_meets_mlx_tpu.tools.viewer import LiveViewer
from nerf_meets_mlx_tpu.utils.video import encode_png


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read()


def test_png_encoder_roundtrip():
    import imageio.v2 as imageio
    import io

    img = np.random.default_rng(0).uniform(size=(16, 24, 3)).astype(np.float32)
    data = encode_png(img)
    decoded = imageio.imread(io.BytesIO(data)).astype(np.float32) / 255.0
    assert decoded.shape == (16, 24, 3)
    assert np.abs(decoded - img).max() < 1 / 255 + 1e-6


def test_viewer_endpoints():
    v = LiveViewer(port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{v.port}"
        status, body = _get(base + "/")
        assert status == 200 and b"live training" in body

        # no frame yet -> 404
        try:
            _get(base + "/frame/pred.png")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404

        v.update("pred", np.zeros((8, 8, 3)))
        status, body = _get(base + "/frame/pred.png")
        # native JPEG when the toolchain built, stdlib PNG otherwise
        assert status == 200 and (
            body.startswith(b"\x89PNG") or body.startswith(b"\xff\xd8")
        )

        v.set_state(step=7, loss=0.5)
        status, body = _get(base + "/state")
        state = json.loads(body)
        assert state["step"] == 7 and state["learning"] is True

        # toggle pause
        req = urllib.request.Request(base + "/toggle", method="POST")
        urllib.request.urlopen(req, timeout=5)
        assert v.learning_enabled is False
        urllib.request.urlopen(
            urllib.request.Request(base + "/toggle", method="POST"), timeout=5
        )
        assert v.learning_enabled is True
    finally:
        v.close()


import urllib.error  # noqa: E402  (used in the 404 probe above)
