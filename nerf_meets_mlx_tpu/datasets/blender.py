"""Blender-synthetic (NeRF) dataset loader.

Equivalent of /root/reference/mlx_nerf/dataset/dataloader.py:20-111:
reads ``transforms_{train,val,test}.json`` + PNGs, derives focal from
``camera_angle_x``, builds split indices, generates the 160-pose orbit,
optional half-res downscale (focal halved), white-background compositing and
the Blender near=2/far=6 bounds.

Differences from the reference: images load into one contiguous float32
array ready for device placement; half-res uses area-averaging (the clean
2x2 box filter) instead of PIL LANCZOS; a dataclass replaces the loose
tuple-of-lists return.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from nerf_meets_mlx_tpu.cameras.pose import orbit_poses


@dataclasses.dataclass
class BlenderDataset:
    images: np.ndarray        # [N, H, W, 3] float32 (bkgd composited)
    poses: np.ndarray         # [N, 4, 4] float32
    render_poses: np.ndarray  # [160, 4, 4]
    H: int
    W: int
    focal: float
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float = 2.0
    far: float = 6.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [
                [self.focal, 0, 0.5 * self.W],
                [0, self.focal, 0.5 * self.H],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )


def _half_res_area(img: np.ndarray) -> np.ndarray:
    """2x2 box-filter downscale (cv2.INTER_AREA equivalent for factor 2)."""
    H, W = img.shape[:2]
    return img[: H // 2 * 2, : W // 2 * 2].reshape(
        H // 2, 2, W // 2, 2, -1
    ).mean(axis=(1, 3))


def _half_res_lanczos(img: np.ndarray) -> np.ndarray:
    """PIL Lanczos-3 downscale — the reference's exact half-res filter
    (dataloader.py:76-90: Image.resize(..., Resampling.LANCZOS)). Run per
    channel in PIL float mode 'F' so no uint8 quantization is introduced."""
    from PIL import Image

    H, W = img.shape[:2]
    out = np.empty((H // 2, W // 2, img.shape[2]), np.float32)
    for c in range(img.shape[2]):
        chan = Image.fromarray(np.ascontiguousarray(img[..., c], np.float32), "F")
        out[..., c] = np.asarray(
            chan.resize((W // 2, H // 2), Image.Resampling.LANCZOS), np.float32
        )
    return out


_HALF_RES_FILTERS = {"area": _half_res_area, "lanczos": _half_res_lanczos}


def load_blender_data(
    basedir: str | Path,
    half_res: bool = False,
    testskip: int = 1,
    white_bkgd: bool = True,
    half_res_filter: str = "area",
) -> BlenderDataset:
    """Load a Blender-synthetic scene directory (dataloader.py:20-92)."""
    basedir = Path(basedir)
    splits = ["train", "val", "test"]
    all_imgs, all_poses, counts = [], [], [0]

    from nerf_meets_mlx_tpu.datasets.native_io import load_png_batch

    for s in splits:
        meta = json.loads((basedir / f"transforms_{s}.json").read_text())
        skip = 1 if (s == "train" or testskip == 0) else testskip
        frames = meta["frames"][::skip]
        # threaded native decode (falls back to imageio) — the reference
        # decodes serially per file (dataloader.py:44-50)
        imgs = load_png_batch(
            [basedir / (f["file_path"] + ".png") for f in frames]
        )
        poses = [np.array(f["transform_matrix"], dtype=np.float32) for f in frames]
        all_imgs.append(imgs)
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + imgs.shape[0])

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    images = np.concatenate(all_imgs, axis=0)
    poses = np.concatenate(all_poses, axis=0)

    H, W = images.shape[1:3]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)  # dataloader.py:63-65

    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        filt = _HALF_RES_FILTERS[half_res_filter]
        images = np.stack([filt(im) for im in images]).astype(np.float32)

    # composite alpha (post_load_blender_data, dataloader.py:95-111)
    if images.shape[-1] == 4:
        if white_bkgd:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3]
    images = np.ascontiguousarray(images, dtype=np.float32)

    return BlenderDataset(
        images=images,
        poses=poses,
        render_poses=orbit_poses(160),
        H=int(H),
        W=int(W),
        focal=float(focal),
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
    )


def validate_dataset(ds: BlenderDataset, out_path: str | Path, n: int = 10) -> Path:
    """Write a contact sheet of the first n test images for eyeballing.

    Headless equivalent of the reference's validate_dataset
    (dataloader.py:113-129, which opens a matplotlib window)."""
    from nerf_meets_mlx_tpu.utils.video import write_png

    idx = ds.i_test[:n] if len(ds.i_test) else np.arange(min(n, len(ds.images)))
    cols = min(5, len(idx))
    rows = -(-len(idx) // cols)
    sheet = np.ones((rows * ds.H, cols * ds.W, 3), np.float32)
    for k, i in enumerate(idx):
        r, c = divmod(k, cols)
        sheet[r * ds.H : (r + 1) * ds.H, c * ds.W : (c + 1) * ds.W] = ds.images[i]
    return write_png(out_path, sheet)
