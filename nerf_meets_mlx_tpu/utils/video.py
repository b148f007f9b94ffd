"""Image / video output (reference: __test_nerf.py:326-341 orbit mp4, to8b
at __test_nerf.py:197), with no third-party imaging package:

* PNG: a stdlib ``zlib`` + ``struct`` encoder (8-bit RGB or RGBA).
* Video: MJPEG in an AVI container, encoded by the repo's own native
  library (native/video_writer.cpp via utils/native_video). Where that
  library cannot be built (no C++ compiler), the frames are written as a
  directory of PNGs instead, and the returned path says which.
"""

from __future__ import annotations

import struct
import sys
import zlib
from pathlib import Path
from typing import Iterable

import numpy as np


def to8b(x) -> np.ndarray:
    return (np.clip(np.asarray(x), 0.0, 1.0) * 255.0).astype(np.uint8)


def to_u8_rgb(img) -> np.ndarray:
    """float [0,1] (or u8) image, [H,W] / [H,W,1] / [H,W,3] -> u8 [H,W,3]."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to8b(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got shape {arr.shape}")
    return np.ascontiguousarray(arr)


def encode_png(img) -> bytes:
    """Encode an image as an 8-bit PNG: RGBA when it has 4 channels (u8 or
    float in [0, 1]), otherwise RGB (see to_u8_rgb)."""
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 4:
        arr = np.ascontiguousarray(arr if arr.dtype == np.uint8 else to8b(arr))
        color_type = 6
    else:
        arr = to_u8_rgb(arr)
        color_type = 2
    h, w, c = arr.shape
    # filter byte 0 (None) in front of every scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str | Path, img) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img))
    return path


def write_video(path: str | Path, frames: Iterable[np.ndarray], fps: int = 30) -> Path:
    """Write frames ([H, W, 3], u8 or float in [0, 1]) as an MJPEG AVI at
    ``path`` with an ``.avi`` suffix; returns the path written. Without the
    native library the frames go to ``<path stem>/frame_XXXX.png``."""
    from nerf_meets_mlx_tpu.utils import native_video

    path = Path(path)
    arr = np.stack([to_u8_rgb(fr) for fr in frames])
    avi = native_video.write_avi(path.with_suffix(".avi"), arr, fps=fps)
    if avi is not None:
        return avi
    out_dir = path.with_suffix("")
    print(
        f"[video] native MJPEG writer unavailable; writing PNG frames to {out_dir}",
        file=sys.stderr, flush=True,
    )
    for i, fr in enumerate(arr):
        write_png(out_dir / f"frame_{i:04d}.png", fr)
    return out_dir
