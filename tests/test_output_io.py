"""Image and video output without third-party imaging packages: the stdlib
PNG encoder against the native PNG decoder, and the video writer and a tiny
train + render with flax, orbax, imageio and PIL unimportable."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerf_meets_mlx_tpu.datasets.native_io import load_png_batch, native_available
from nerf_meets_mlx_tpu.utils.video import encode_png, write_png

REPO = Path(__file__).resolve().parents[1]

BLOCK = (
    "import sys\n"
    "for m in ('flax', 'orbax', 'orbax.checkpoint', 'imageio', 'imageio.v2', 'PIL', 'PIL.Image'):\n"
    "    sys.modules[m] = None\n"
)


def _gradient(h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    planes = [x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h), (x * y) % 256]
    return np.stack(planes[:c], -1).astype(np.uint8)


@pytest.mark.parametrize(
    "kind", ["rgb_u8", "rgba_u8", "rgb_float", "gray_float"]
)
def test_png_writer_matches_native_loader(tmp_path, kind):
    if not native_available():
        pytest.skip("native PNG loader could not be built (no C++ compiler)")
    if kind == "rgb_u8":
        img, want = _gradient(23, 37, 3), None
    elif kind == "rgba_u8":
        img, want = _gradient(16, 9, 4), None
    elif kind == "rgb_float":
        img = np.random.default_rng(0).uniform(size=(11, 13, 3)).astype(np.float32)
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    else:
        img = np.random.default_rng(1).uniform(size=(8, 8)).astype(np.float32)
        want = np.repeat((img * 255).astype(np.uint8)[..., None], 3, -1)
    want = img if want is None else want
    path = write_png(tmp_path / "sub" / "x.png", img)
    assert path.read_bytes() == encode_png(img)
    dec = load_png_batch([path])[0]  # float32 RGBA in [0, 1]
    got = np.rint(dec * 255).astype(np.uint8)
    np.testing.assert_array_equal(got[..., : want.shape[-1]], want)
    if want.shape[-1] == 3:
        assert (got[..., 3] == 255).all()


def _run_blocked(code: str, tmp_path: Path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "-c", BLOCK + code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_video_writer_without_imageio_or_pil(tmp_path):
    r = _run_blocked(
        "import numpy as np\n"
        "from nerf_meets_mlx_tpu.utils.video import write_video\n"
        "frames = [np.full((16, 24, 3), i * 40, np.uint8) for i in range(4)]\n"
        f"print(write_video({str(tmp_path / 'v.mp4')!r}, frames, fps=5))\n",
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    out = Path(r.stdout.strip().splitlines()[-1])
    assert out.exists()
    if out.suffix == ".avi":
        assert out.read_bytes()[:4] == b"RIFF"
    else:  # no C++ compiler: PNG frames
        assert len(list(out.glob("frame_*.png"))) == 4


def test_tiny_train_and_render_without_optional_packages(tmp_path):
    """train (checkpoint, held-out PNG, orbit video), resume and render, with
    flax, orbax, imageio and PIL unimportable."""
    log = tmp_path / "run"
    r = _run_blocked(
        "import dataclasses\n"
        "from nerf_meets_mlx_tpu import config as C\n"
        "base = C.lego_hierarchical\n"
        "def tiny():\n"
        "    cfg = base()\n"
        "    mlp = C.MLPConfig(net_depth=2, net_width=8, skips=())\n"
        "    return cfg.replace(mlp=mlp, mlp_fine=mlp,\n"
        "        render=dataclasses.replace(cfg.render, n_samples=4, n_importance=4, ray_chunk=256),\n"
        "        train=dataclasses.replace(cfg.train, n_rand=32),\n"
        "        data=dataclasses.replace(cfg.data, synth_n_train=2, synth_n_val=1, synth_n_test=1))\n"
        "C.PRESETS['lego_hierarchical'] = tiny\n"
        "from nerf_meets_mlx_tpu.datasets import synthetic\n"
        "orbit = synthetic.orbit_poses\n"
        "synthetic.orbit_poses = lambda n=160, **k: orbit(3, **k)\n"
        "from nerf_meets_mlx_tpu.__main__ import main\n"
        f"log = {str(log)!r}\n"
        "a = main(['train', '--synth-resolution', '8', '--max-iters', '3', '--precrop-iters', '0', '--no-shard', '--log-dir', log])\n"
        "b = main(['train', '--synth-resolution', '8', '--max-iters', '5', '--precrop-iters', '0', '--no-shard', '--no-video', '--log-dir', log])\n"
        "c = main(['render', '--log-dir', log, '--render-test'])\n"
        "assert (a['step'], b['start_step'], b['step'], c['step']) == (3, 3, 5, 5), (a, b, c)\n"
        "for m in ('flax', 'orbax', 'imageio', 'PIL'):\n"
        "    assert sys.modules[m] is None\n"
        "print('VIDEO', a['video'])\n",
        tmp_path,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert (log / "render_00000003.png").is_file()
    assert (log / "ckpt" / "step_00000005" / "state.npz").is_file()
    video = Path(r.stdout.split("VIDEO ")[-1].strip())
    assert video.exists()
