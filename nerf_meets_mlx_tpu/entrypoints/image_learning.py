"""2-D image-learning entrypoint.

Counterpart of /root/reference/mlx_nerf/entrypoints/__viser_image_learning.py
without the viser GUI dependency (headless hosts): trains the MLP to
reproduce an RGB image, periodically writing predicted frames + a final
training-progress video. The reference's live viser loop is optional
(see tools/viewer.py for the interactive path).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.config import image2d
from nerf_meets_mlx_tpu.datasets import load_image_2d
from nerf_meets_mlx_tpu.datasets.image import pixel_dataset
from nerf_meets_mlx_tpu.engine import Trainer, make_image_train_step
from nerf_meets_mlx_tpu.models import create_nerf
from nerf_meets_mlx_tpu.ops import psnr as psnr_fn
from nerf_meets_mlx_tpu.utils.logging import log_devices
from nerf_meets_mlx_tpu.utils.video import to8b, write_png, write_video


def image_learning(
    image_path: Optional[str] = None,
    size: int = 400,
    max_iters: int = 1000,
    log_dir: Optional[str] = None,
    frame_every: int = 50,
    viewer_port: Optional[int] = None,
) -> dict:
    """Overfit an MLP to one image; returns final PSNR.

    With viewer_port set, serves the live GUI (GT/prediction images,
    metrics, pause/resume) — the reference's viser loop
    (__viser_image_learning.py:238-315) without the viser dependency."""
    log_devices("image")
    cfg = image2d()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iters=max_iters))
    img = load_image_2d(image_path, size)
    H, W = img.shape[:2]
    coords, colors = pixel_dataset(img)
    coords = jax.device_put(jnp.asarray(coords))
    colors = jax.device_put(jnp.asarray(colors))

    model = create_nerf(cfg)
    trainer = Trainer(
        cfg, model, make_image_train_step(model), (coords, colors), log_dir=log_dir
    )

    @jax.jit
    def predict(params):
        pred = model.query(params, "coarse", coords[:, None, :], None)[:, 0, :]
        return pred.reshape(H, W, 3)

    viewer = None
    if viewer_port is not None:
        from nerf_meets_mlx_tpu.tools.viewer import LiveViewer

        viewer = LiveViewer(port=viewer_port)
        viewer.update("gt", img)
        print(f"[viewer] http://localhost:{viewer.port}/", flush=True)

    frames = []
    while trainer.step < max_iters:
        if viewer is not None:
            viewer.wait_if_paused()
        metrics = trainer.run(min(frame_every, max_iters - trainer.step))
        pred_img = predict(trainer.state.params)
        frames.append(to8b(pred_img))
        if viewer is not None:
            viewer.update("pred", np.asarray(pred_img))
            viewer.set_state(step=trainer.step, **metrics)

    pred = predict(trainer.state.params)
    final_psnr = float(psnr_fn(pred, jnp.asarray(img)))
    trainer.logger.log(step=trainer.step, final_psnr=final_psnr)
    out_dir = Path(trainer.log_dir)
    write_png(out_dir / "final.png", pred)
    video = write_video(out_dir / "progress.avi", frames, fps=10)
    return {"final_psnr": final_psnr, "steps": trainer.step, "video": str(video)}
