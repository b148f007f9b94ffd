"""LLFF (forward-facing, real-capture) dataset loader.

The reference ships only FLAGS for LLFF — ``--llffhold``, ``--spherify``,
``--lindisp``, ``--no_ndc`` (/root/reference/mlx_nerf/config_parser.py:58-71)
— with no loader behind them (its only loader is the Blender one,
dataset/dataloader.py:20). This module supplies the real capability, built
fresh from the LLFF ``poses_bounds.npy`` format:

* ``poses_bounds.npy``: [N, 17] rows = a 3x5 matrix (3x4 camera-to-world in
  LLFF's [down, right, back] convention + a [H, W, focal] column) followed
  by the per-image [near, far] depth bounds.
* images live in ``images/`` (or pre-minified ``images_{factor}/``).

Processing mirrors standard NeRF-LLFF semantics: axis-swap to the NeRF
[right, up, back] convention, global scale so min(bounds)*bd_factor == 1,
recentering about the average pose, and a spiral render path. Splits follow
``llffhold`` (every k-th image is test/val, the rest train).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class LLFFDataset:
    images: np.ndarray        # [N, H, W, 3] float32
    poses: np.ndarray         # [N, 4, 4] float32 (NeRF convention, recentered)
    render_poses: np.ndarray  # [n_render, 4, 4] spiral path
    bounds: np.ndarray        # [N, 2] scaled scene depth bounds
    H: int
    W: int
    focal: float
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float               # suggested sampling bounds (pre-NDC space)
    far: float

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


def _downsample_area(img: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor box-filter downscale (this build's minify — the
    original LLFF pipeline shells out to imagemagick)."""
    H, W = img.shape[:2]
    Hc, Wc = H // factor * factor, W // factor * factor
    return (
        img[:Hc, :Wc]
        .reshape(Hc // factor, factor, Wc // factor, factor, -1)
        .mean(axis=(1, 3))
    )


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3, 4] c2w with columns [x, y, z, pos] from a forward vector z."""
    z = _normalize(z)
    x = _normalize(np.cross(up, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, pos], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """[3, 4] average camera: mean center, mean z, mean y as up."""
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _view_matrix(z, up, center)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform all poses so the average pose is the identity."""
    c2w = np.concatenate([average_pose(poses), np.array([[0, 0, 0, 1.0]])], 0)
    bottom = np.tile(np.array([[0, 0, 0, 1.0]]), (len(poses), 1, 1))
    poses_h = np.concatenate([poses[:, :3, :4], bottom], 1)
    return (np.linalg.inv(c2w) @ poses_h).astype(np.float32)


def spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
) -> np.ndarray:
    """Spiral render path around the average pose, looking at the scene's
    mean focus depth (the LLFF demo-video camera path)."""
    c2w = average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))

    close, inf = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal_depth = 1.0 / ((1.0 - dt) / close + dt / inf)

    # spiral radii: 90th percentile of camera offsets from the average pose
    rads = np.percentile(np.abs(poses[:, :3, 3] - c2w[:3, 3]), 90, axis=0)
    rads = np.concatenate([rads, [1.0]])

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = c - c2w[:3, :4] @ np.array([0, 0, -focal_depth, 1.0])
        mat = np.concatenate([_view_matrix(z, up, c), np.array([[0, 0, 0, 1.0]])], 0)
        out.append(mat)
    return np.stack(out).astype(np.float32)


def _closest_point_to_axes(origins: np.ndarray, axes: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing summed squared distance to the lines
    {o_i + t d_i}: solve (Σ (I − d dᵀ)) p = Σ (I − d dᵀ) o."""
    d = axes / np.linalg.norm(axes, axis=-1, keepdims=True)
    P = np.eye(3) - d[:, :, None] * d[:, None, :]  # [N, 3, 3] projectors
    A = P.sum(0)
    b = (P @ origins[:, :, None]).sum(0)[:, 0]
    return np.linalg.solve(A, b)


def spherify_poses(
    poses: np.ndarray, bounds: np.ndarray, n_render_poses: int = 120
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-frame an inward-facing (360°) capture for spherical sampling.

    The reference carries only the ``--spherify`` flag
    (/root/reference/mlx_nerf/config_parser.py:62-63) with nothing behind it;
    this supplies the capability: translate the scene so the point all view
    axes pass closest to sits at the origin, rotate so the cameras' mean
    offset becomes +z ("up"), and rescale to unit mean camera distance.
    Returns (poses [N,4,4], circular render path [n,4,4], rescaled bounds).
    """
    p34 = poses[:, :3, :4]
    origins = p34[:, :, 3]
    view_axes = p34[:, :, 2]  # NeRF convention: camera looks along −z
    center = _closest_point_to_axes(origins, view_axes)

    z = _normalize((origins - center).mean(0))
    # any vector not parallel to z seeds the orthonormal frame
    seed = np.array([0.1, 0.2, 0.3])
    x = _normalize(np.cross(seed, z))
    y = np.cross(z, x)
    w2c = np.eye(4, dtype=np.float64)
    w2c[:3, :3] = np.stack([x, y, z], axis=0)
    w2c[:3, 3] = -w2c[:3, :3] @ center

    bottom = np.tile(np.array([[0, 0, 0, 1.0]]), (len(poses), 1, 1))
    new_poses = w2c @ np.concatenate([p34, bottom], 1)

    radii = np.linalg.norm(new_poses[:, :3, 3], axis=-1)
    sc = 1.0 / radii.mean()
    new_poses[:, :3, 3] *= sc
    new_bounds = bounds * sc

    # circular path at the cameras' mean height, looking at the origin
    zh = float(new_poses[:, 2, 3].mean())
    r2 = float((new_poses[:, :3, 3] ** 2).sum(-1).mean())
    rad = np.sqrt(max(r2 - zh * zh, 1e-6))
    up_w = np.array([0.0, 0.0, 1.0])
    render = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_render_poses, endpoint=False):
        pos = np.array([rad * np.cos(th), rad * np.sin(th), zh])
        back = _normalize(pos)  # c2w z column: from the origin toward the camera
        mat = np.concatenate(
            [_view_matrix(back, up_w, pos), np.array([[0, 0, 0, 1.0]])], 0
        )
        render.append(mat)
    return (
        new_poses.astype(np.float32),
        np.stack(render).astype(np.float32),
        new_bounds.astype(np.float32),
    )


def load_llff_data(
    basedir: str | Path,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    llffhold: int = 8,
    n_render_poses: int = 120,
    spherify: bool = False,
) -> LLFFDataset:
    """Load an LLFF capture directory (poses_bounds.npy + images/)."""
    basedir = Path(basedir)
    pb = np.load(basedir / "poses_bounds.npy")  # [N, 17]
    poses_raw = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, 15:17].astype(np.float32)

    # prefer a pre-minified directory; otherwise box-filter ourselves
    img_dir = basedir / (f"images_{factor}" if factor > 1 else "images")
    minify = not img_dir.exists()
    if minify:
        img_dir = basedir / "images"
    files = sorted(
        p for p in img_dir.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    if len(files) != len(poses_raw):
        raise ValueError(
            f"{len(files)} images in {img_dir} but {len(poses_raw)} poses"
        )

    from nerf_meets_mlx_tpu.datasets.native_io import load_png_batch

    pngs = [p for p in files if p.suffix.lower() == ".png"]
    if len(pngs) == len(files):
        images = load_png_batch(files)
    else:  # mixed/jpeg captures go through imageio
        import imageio.v2 as imageio

        images = np.stack(
            [np.asarray(imageio.imread(p), np.float32) / 255.0 for p in files]
        )
    if images.shape[-1] == 4:
        images = images[..., :3]
    if minify and factor > 1:
        images = np.stack(
            [_downsample_area(im, factor) for im in images]
        ).astype(np.float32)

    H, W = images.shape[1:3]
    # the hwf column stores the ORIGINAL capture dims; rescale focal to ours
    hwf = poses_raw[0, :3, 4]
    focal = float(hwf[2]) * (W / float(hwf[1]))

    # LLFF [down, right, back] -> NeRF [right, up, back]
    poses = np.concatenate(
        [poses_raw[:, :, 1:2], -poses_raw[:, :, 0:1], poses_raw[:, :, 2:4]],
        axis=2,
    ).astype(np.float32)  # [N, 3, 4]

    # global metric scale: min depth bound -> 1/bd_factor
    sc = 1.0 if bd_factor is None else 1.0 / (float(bounds.min()) * bd_factor)
    poses[:, :3, 3] *= sc
    bounds = bounds * sc

    if recenter:
        poses = recenter_poses(poses)
    else:
        bottom = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (len(poses), 1, 1))
        poses = np.concatenate([poses, bottom], 1)

    if spherify:
        poses, render_poses, bounds = spherify_poses(
            poses, bounds, n_render_poses=n_render_poses
        )
    else:
        render_poses = spiral_path(poses, bounds, n_frames=n_render_poses)

    n = len(images)
    i_test = np.arange(n)[::llffhold] if llffhold > 0 else np.array([n - 1])
    i_val = i_test
    i_train = np.array([i for i in range(n) if i not in i_test])

    near = float(bounds.min()) * 0.9
    far = float(bounds.max()) * 1.0

    return LLFFDataset(
        images=np.ascontiguousarray(images, np.float32),
        poses=poses.astype(np.float32),
        render_poses=render_poses,
        bounds=bounds,
        H=int(H),
        W=int(W),
        focal=focal,
        i_train=i_train,
        i_val=i_val,
        i_test=i_test,
        near=near,
        far=far,
    )
