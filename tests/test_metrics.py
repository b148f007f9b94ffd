"""Metrics: MSE/PSNR formulas, SSIM properties."""

import jax
import jax.numpy as jnp
import numpy as np

from nerf_meets_mlx_tpu.ops import mse, psnr, ssim
from nerf_meets_mlx_tpu.ops.metrics import mse_to_psnr


def test_mse_psnr_formulas():
    a = jnp.zeros((4, 4, 3))
    b = jnp.full((4, 4, 3), 0.1)
    np.testing.assert_allclose(float(mse(a, b)), 0.01, rtol=1e-6)
    np.testing.assert_allclose(float(psnr(a, b)), 20.0, rtol=1e-5)
    np.testing.assert_allclose(float(mse_to_psnr(jnp.asarray(0.01))), 20.0, rtol=1e-5)


def test_psnr_identical_images_large():
    a = jnp.ones((8, 8, 3)) * 0.5
    assert float(psnr(a, a + 1e-6)) > 100.0


def test_ssim_self_is_one():
    img = jax.random.uniform(jax.random.PRNGKey(0), (32, 32, 3))
    np.testing.assert_allclose(float(ssim(img, img)), 1.0, atol=1e-5)


def test_ssim_decreases_with_noise():
    key = jax.random.PRNGKey(1)
    img = jax.random.uniform(key, (48, 48, 3))
    small = img + jax.random.normal(jax.random.PRNGKey(2), img.shape) * 0.02
    big = img + jax.random.normal(jax.random.PRNGKey(3), img.shape) * 0.3
    s_small = float(ssim(jnp.clip(small, 0, 1), img))
    s_big = float(ssim(jnp.clip(big, 0, 1), img))
    assert 1.0 > s_small > s_big


def test_ssim_grayscale_input():
    img = jax.random.uniform(jax.random.PRNGKey(0), (32, 32))
    assert 0.99 < float(ssim(img, img)) <= 1.0 + 1e-6


def test_ssim_never_exceeds_one():
    """SSIM <= 1 for ANY inputs — a reduced-precision conv (bf16 or TF32)
    violated this on real renders (measured 1.62) until the conv precision
    was pinned to HIGHEST."""
    rng = np.random.default_rng(3)
    base = jnp.asarray(rng.uniform(size=(96, 96, 3)), jnp.float32)
    smooth = jnp.asarray(
        np.cumsum(np.cumsum(rng.normal(size=(96, 96, 3)), 0), 1), jnp.float32
    )
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    for a, b in ((base, base * 0.97), (smooth, jnp.clip(smooth + 0.02, 0, 1))):
        assert float(ssim(a, b)) <= 1.0 + 1e-5
