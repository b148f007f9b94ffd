"""Image-quality metrics in pure JAX.

The reference ships MSE/PSNR and a *broken, unfinished* SSIM (it calls
mlx ``nn.Conv2d`` as a function and the body ends at a TODO —
/root/reference/mlx_nerf/ops/metric.py:20-64) plus an LPIPS wrapper around
the torch ``lpips`` package (metric.py:66-76). Here MSE/PSNR match the
reference formulas (metric.py:12-18) and SSIM is implemented properly
(Wang et al. 2004, 11x11 Gaussian window) with depthwise convolutions.
LPIPS (a learned torch metric) is exposed via
``lpips_torch`` only if the optional package is importable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def mse(pred: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((pred - gt) ** 2)


def psnr(pred: jnp.ndarray, gt: jnp.ndarray, max_val: float = 1.0) -> jnp.ndarray:
    """PSNR = 10 log10(max^2 / MSE) (reference metric.py:16-18 with max=1)."""
    return 10.0 * jnp.log10(max_val**2 / mse(pred, gt))


def mse_to_psnr(x: jnp.ndarray) -> jnp.ndarray:
    """Working version of the reference's unimplemented loss_to_PSNR
    (metric.py:8-10)."""
    return -10.0 * jnp.log10(x)


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(
    pred: jnp.ndarray,  # [H, W, C] in [0, max_val]
    gt: jnp.ndarray,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> jnp.ndarray:
    """Mean SSIM over the image (valid padding, per-channel averaged)."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    win = jnp.asarray(_gaussian_window(window_size, sigma))[None, None]  # [1,1,K,K]

    # NCHW, depthwise via feature_group_count
    def to_nchw(x):
        if x.ndim == 2:
            x = x[..., None]
        return jnp.transpose(x, (2, 0, 1))[None]  # [1, C, H, W]

    p, g = to_nchw(pred), to_nchw(gt)
    C = p.shape[1]
    kern = jnp.tile(win, (C, 1, 1, 1))  # [C,1,K,K]
    conv = functools.partial(
        jax.lax.conv_general_dilated,
        rhs=kern,
        window_strides=(1, 1),
        padding="VALID",
        feature_group_count=C,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # full f32 precision: reduced-precision conv multiplies (bf16, or
        # TF32 on GPUs) have an error on conv(x^2) - mu^2 that dwarfs c2
        # (~9e-4) and can push SSIM past 1
        precision=jax.lax.Precision.HIGHEST,
    )

    mu_p, mu_g = conv(p), conv(g)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    sig_pp = conv(p * p) - mu_pp
    sig_gg = conv(g * g) - mu_gg
    sig_pg = conv(p * g) - mu_pg

    num = (2.0 * mu_pg + c1) * (2.0 * sig_pg + c2)
    den = (mu_pp + mu_gg + c1) * (sig_pp + sig_gg + c2)
    return jnp.mean(num / den)


def lpips_torch(pred, gt, net: str = "vgg"):
    """Optional LPIPS via the torch ``lpips`` package (CPU), mirroring the
    reference wrapper (metric.py:66-76). Raises ImportError if unavailable."""
    import lpips  # noqa: deferred optional dep
    import torch

    model = lpips.LPIPS(net=net)
    to_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).permute(2, 0, 1)[None]
    with torch.no_grad():
        err = model(to_t(pred) * 2 - 1, to_t(gt) * 2 - 1)
    return float(err.mean())
