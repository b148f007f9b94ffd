"""ctypes binding for the native MJPEG-AVI video writer (native/video_writer.cpp).

The reference writes its orbit mp4 through imageio's ffmpeg binary
(/root/reference/mlx_nerf/entrypoints/__test_nerf.py:326-341). This binding
provides a dependency-free video path: baseline JPEG frames (encoded across
hardware threads in C++) in a RIFF/AVI container with the MJPG fourcc.
Returns None if the toolchain or library is unavailable — utils/video.py
then writes PNG frames.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_meets_mlx_tpu.utils.native_lib import load_native_lib


def _register(lib: ctypes.CDLL) -> None:
    lib.avi_write_mjpeg.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.avi_write_mjpeg.restype = ctypes.c_int
    lib.jpeg_encode_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
    ]
    lib.jpeg_encode_rgb.restype = ctypes.c_long


def _load_lib() -> Optional[ctypes.CDLL]:
    return load_native_lib("libvideo_writer.so", _register)


def _as_u8_rgb(arr: np.ndarray, what: str) -> np.ndarray:
    """Normalize to contiguous u8 RGB with a trailing 3-channel axis.
    Floats are treated as [0, 1] (the framework convention); anything that
    is not 3-channel after grayscale expansion is rejected — the C++ side
    reads exactly h*w*3 bytes."""
    arr = np.asarray(arr)
    if np.issubdtype(arr.dtype, np.floating):
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    elif arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] != 3:
        raise ValueError(f"expected {what} with 3 channels, got shape {arr.shape}")
    return np.ascontiguousarray(arr)


def write_avi(path, frames: np.ndarray, fps: int = 30, quality: int = 90) -> Optional[Path]:
    """Write RGB frames [N, H, W, 3] (u8, or float in [0,1]) as an MJPEG AVI.
    Returns the path on success, None if the native library is unavailable
    or writing failed."""
    lib = _load_lib()
    if lib is None:
        return None
    frames = _as_u8_rgb(frames, "frames [N, H, W, 3]")
    if frames.ndim != 4:
        raise ValueError(f"expected [N, H, W, 3] frames, got {frames.shape}")
    n, h, w, _ = frames.shape
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rc = lib.avi_write_mjpeg(
        str(path).encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, int(fps), int(quality),
    )
    return path if rc == 0 else None


def encode_jpeg(frame: np.ndarray, quality: int = 90) -> Optional[bytes]:
    """Encode one RGB frame [H, W, 3] (u8, or float in [0,1]; grayscale
    [H, W, 1] expanded) to baseline JPEG bytes, or None if the native
    library is unavailable."""
    lib = _load_lib()
    if lib is None:
        return None
    frame = _as_u8_rgb(frame, "frame [H, W, 3]")
    if frame.ndim != 3:
        raise ValueError(f"expected [H, W, 3] frame, got {frame.shape}")
    h, w, _ = frame.shape
    cap = h * w * 3 + 65536
    out = np.empty(cap, np.uint8)
    nbytes = lib.jpeg_encode_rgb(
        frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, int(quality),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if nbytes <= 0:
        return None
    return out[:nbytes].tobytes()
