"""Native MJPEG-AVI video writer (native/video_writer.cpp + utils/native_video).

The JPEG stream is validated by decoding with PIL (an independent decoder);
the AVI container structurally (RIFF signature, header lists, frame chunks,
index). write_video's AVI path and its PNG-frame fallback are exercised
end-to-end.
"""

import io
import struct

import numpy as np
import pytest

from nerf_meets_mlx_tpu.utils import native_video
from nerf_meets_mlx_tpu.utils.video import to8b, write_video

pytestmark = pytest.mark.skipif(
    native_video._load_lib() is None, reason="native toolchain unavailable"
)


def _test_frame(h=48, w=64):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack(
        [x * 255 // w, y * 255 // h, ((x + y) * 255) // (w + h)], -1
    ).astype(np.uint8)


def test_jpeg_roundtrip_psnr():
    from PIL import Image

    frame = _test_frame()
    jpg = native_video.encode_jpeg(frame, quality=92)
    assert jpg is not None and jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
    dec = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"), np.float32)
    mse = np.mean((dec - frame.astype(np.float32)) ** 2)
    psnr = 10 * np.log10(255.0**2 / mse)
    assert psnr > 35.0, f"JPEG roundtrip PSNR {psnr:.1f} dB"


def test_jpeg_nonmultiple_of_8():
    from PIL import Image

    frame = _test_frame(h=37, w=53)  # edge-replicated partial blocks
    jpg = native_video.encode_jpeg(frame, quality=90)
    img = Image.open(io.BytesIO(jpg))
    assert img.size == (53, 37)
    dec = np.asarray(img.convert("RGB"), np.float32)
    mse = np.mean((dec - frame.astype(np.float32)) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 33.0


def test_avi_structure(tmp_path):
    n = 6
    base = _test_frame()
    frames = np.stack([np.roll(base, 4 * i, axis=1) for i in range(n)])
    path = native_video.write_avi(tmp_path / "orbit.avi", frames, fps=10)
    assert path is not None
    data = path.read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    riff_size = struct.unpack("<I", data[4:8])[0]
    assert riff_size == len(data) - 8
    assert b"hdrl" in data and b"movi" in data and b"idx1" in data
    assert data.count(b"00dc") >= 2 * n  # movi chunks + idx1 entries
    assert b"MJPG" in data
    # frame count in avih (offset: RIFF(12) + LIST hdr(8) + 'hdrl'(4) +
    # 'avih'(4) + size(4) + 4 dwords -> dwTotalFrames)
    avih = data.index(b"avih")
    total_frames = struct.unpack("<I", data[avih + 8 + 16 : avih + 8 + 20])[0]
    assert total_frames == n


def test_avi_first_frame_decodes(tmp_path):
    from PIL import Image

    frames = np.stack([_test_frame() for _ in range(3)])
    path = native_video.write_avi(tmp_path / "v.avi", frames, fps=5)
    data = path.read_bytes()
    movi = data.index(b"movi")
    first = data.index(b"00dc", movi)
    size = struct.unpack("<I", data[first + 4 : first + 8])[0]
    jpg = data[first + 8 : first + 8 + size]
    dec = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"), np.float32)
    assert dec.shape == frames[0].shape
    mse = np.mean((dec - frames[0].astype(np.float32)) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 35.0


def test_float_and_gray_inputs():
    """Float [0,1] frames must not be silently truncated to black, and
    single-channel frames expand rather than over-read in C++."""
    from PIL import Image

    f = np.full((16, 16, 3), 0.5, np.float32)
    jpg = native_video.encode_jpeg(f, quality=95)
    dec = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"), np.float32)
    assert abs(dec.mean() - 127.5) < 3.0  # not black

    g = np.random.rand(16, 16, 1).astype(np.float32)
    assert native_video.encode_jpeg(g) is not None  # expanded, no OOB read

    with pytest.raises(ValueError):
        native_video.encode_jpeg(np.zeros((16, 16, 4), np.uint8))  # RGBA rejected

    path = native_video.write_avi("/tmp/_f.avi", np.full((2, 16, 16, 3), 0.5), fps=5)
    assert path is not None and path.stat().st_size > 200


def test_write_video_falls_back_to_avi(tmp_path, monkeypatch):
    """write_video produces the native MJPEG AVI, whatever suffix it is
    given."""
    frames = [to8b(np.random.rand(32, 40, 3)) for _ in range(4)]
    out = write_video(tmp_path / "orbit.mp4", frames, fps=8)
    assert out == tmp_path / "orbit.avi"
    assert out.exists() and out.stat().st_size > 500
    assert out.read_bytes()[:4] == b"RIFF"


def test_write_video_gif_fallback(tmp_path, monkeypatch):
    """If the native library is unavailable, the frames are written as a
    directory of PNGs (stdlib encoder) that decode back to the frames."""
    monkeypatch.setattr(native_video, "write_avi", lambda *a, **k: None)
    frames = [to8b(np.random.rand(16, 16, 3)) for _ in range(3)]
    out = write_video(tmp_path / "orbit.avi", frames, fps=8)
    assert out == tmp_path / "orbit" and out.is_dir()
    pngs = sorted(out.glob("frame_*.png"))
    assert len(pngs) == 3
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(pngs[1]).convert("RGB")), frames[1])
