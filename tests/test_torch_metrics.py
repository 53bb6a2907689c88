"""The port's image metrics (PSNR, SSIM, FLIP, LPIPS) against the JAX
package's on the same numpy images."""
import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch import metrics

# PSNR: one f32 mean of squares on each side, summed in another order.
PSNR_RTOL = 1e-6
# SSIM: the same window, but XLA's and torch's convolutions sum the 121 taps
# in another order; the SSIM map's ratio keeps that at a few f32 ulps of the
# local statistics: measured 6e-7.
SSIM_ATOL = 2e-6
# FLIP: the CSF filters reach 40 taps on each side at the default pixels per
# degree, and the colour pipeline's powers (0.7, 1/3, 2.4) amplify the
# convolutions' summation-order noise: measured 2.8e-6 on a map of ~0.1.
FLIP_ATOL = 2e-5
# LPIPS: five f32 convolutions of up to 363 taps, each summed in another
# order, then unit-normalised features: measured 2.6e-7 relative.
LPIPS_RTOL = 1e-4


def _pair(rng, shape):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_matches_jax(rng):
    import jax.numpy as jnp

    from efficient_nerf_tpu import metrics as jm

    a, b = _pair(rng, (2, 16, 12, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.img2mse(ta, tb)),
                               float(jm.img2mse(jnp.asarray(a), jnp.asarray(b))),
                               rtol=PSNR_RTOL)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jm.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=PSNR_RTOL)
    m = np.float32([0.5, 1e-3, 0.0123])
    np.testing.assert_allclose(metrics.mse2psnr(torch.from_numpy(m)).numpy(),
                               np.asarray(jm.mse2psnr(jnp.asarray(m))), rtol=PSNR_RTOL)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 32, 24, 3), (3, 11, 20, 1)])
@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(shape, size_average, rng):
    import jax.numpy as jnp

    from efficient_nerf_tpu import metrics as jm

    a, b = _pair(rng, shape)
    got = metrics.ssim(torch.from_numpy(a), torch.from_numpy(b),
                       size_average=size_average).numpy()
    want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SSIM_ATOL, rtol=0)


def test_ssim_image_and_identity(rng):
    import jax.numpy as jnp

    from efficient_nerf_tpu import metrics as jm

    a, b = _pair(rng, (20, 20, 3))
    np.testing.assert_allclose(
        float(metrics.ssim_image(torch.from_numpy(a), torch.from_numpy(b),
                                 window_size=7, sigma=1.0)),
        float(jm.ssim_image(jnp.asarray(a), jnp.asarray(b), window_size=7, sigma=1.0)),
        atol=SSIM_ATOL)
    np.testing.assert_allclose(float(metrics.ssim_image(torch.from_numpy(a),
                                                        torch.from_numpy(a))), 1.0, atol=1e-6)


@pytest.mark.parametrize("ppd", [None, 20.0])
def test_flip_matches_jax(ppd, rng):
    import jax.numpy as jnp

    from efficient_nerf_tpu import metrics as jm

    a, b = _pair(rng, (2, 32, 24, 3))
    got = metrics.flip_error_map(torch.from_numpy(a), torch.from_numpy(b), ppd).numpy()
    want = np.asarray(jm.flip_error_map(jnp.asarray(a), jnp.asarray(b), ppd))
    assert got.shape == want.shape == (2, 32, 24, 1)
    np.testing.assert_allclose(got, want, atol=FLIP_ATOL, rtol=0)
    np.testing.assert_allclose(float(metrics.flip(torch.from_numpy(a), torch.from_numpy(b), ppd)),
                               float(jm.flip(jnp.asarray(a), jnp.asarray(b), ppd)),
                               atol=FLIP_ATOL)
    assert metrics.default_pixels_per_degree() == jm.default_pixels_per_degree()


def _random_lpips_weights(rng):
    """Random weights in the JAX package's .npz layout, at narrow widths
    (tests/test_metrics.py:107-122)."""
    chans = [(3, 8, 11), (8, 12, 5), (12, 16, 3), (16, 16, 3), (16, 16, 3)]
    w = {}
    for i, (cin, cout, k) in enumerate(chans):
        w[f"conv{i}_w"] = (rng.normal(size=(cout, cin, k, k)) * 0.1).astype(np.float32)
        w[f"conv{i}_b"] = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(-0.2, 1, size=(1, cout, 1, 1)).astype(np.float32)
    w["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    w["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    return w


def test_lpips_matches_jax_through_a_weights_file(tmp_path, rng):
    import jax.numpy as jnp

    from efficient_nerf_tpu import metrics as jm
    from efficient_nerf_tpu_torch.metrics.lpips import load_lpips_weights

    # no weights ship with either package
    assert not metrics.lpips_available() and not jm.lpips_available()
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **_random_lpips_weights(rng))
    assert metrics.lpips_available(path)
    img0 = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    img1 = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    got = metrics.lpips(torch.from_numpy(img0), torch.from_numpy(img1),
                        weights_path=path).numpy()
    want = np.asarray(jm.lpips(jnp.asarray(img0), jnp.asarray(img1), weights_path=path))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
    w = load_lpips_weights(path)
    np.testing.assert_allclose(
        metrics.lpips(torch.from_numpy(img0), torch.from_numpy(img1), weights=w).numpy(),
        got, rtol=0, atol=0)


@pytest.mark.cuda
def test_metrics_on_the_card_match_the_cpu(rng, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # cuDNN's convolutions run in TF32 unless told otherwise
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    a, b = _pair(rng, (2, 32, 24, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ca, cb = ta.cuda(), tb.cuda()
    torch.testing.assert_close(metrics.psnr(ca, cb).cpu(), metrics.psnr(ta, tb),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(metrics.ssim(ca, cb).cpu(), metrics.ssim(ta, tb),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(metrics.flip(ca, cb).cpu(), metrics.flip(ta, tb),
                               rtol=0, atol=1e-4)
