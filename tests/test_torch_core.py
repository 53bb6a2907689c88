"""The port's ray, sampling, encoding and pose math against the JAX package
on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core import encoding as jenc
from efficient_nerf_tpu.core import poses as jposes
from efficient_nerf_tpu.core import ray_sampler as jrs
from efficient_nerf_tpu.core import rays as jrays
from efficient_nerf_tpu.core import sampling as jsamp
from efficient_nerf_tpu_torch.core import encoding, poses, ray_sampler, rays, sampling

CPU = "cpu"
# f32 geometry computed in the same order: differences are a few ulps
GEOM_TOL = 1e-6
# sin/cos at up to ~3e3 rad, where an f32 ulp of the argument is ~2.4e-4 rad;
# the two formulations may differ by a few ulps there (tests/test_ops.py:20-23)
EMBED_TOL = 2e-3


def _rays(rng, B=13):
    o = rng.normal(size=(B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("theta,phi,radius", [(30.0, -30.0, 4.0),
                                              (-150.0, -60.0, 3.2)])
def test_pose_spherical(theta, phi, radius):
    got = poses.pose_spherical(theta, phi, radius)
    want = jposes.pose_spherical(theta, phi, radius)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,W,focal_scale", [(8, 8, 1.0), (5, 7, 1.3)])
def test_get_rays(H, W, focal_scale):
    c2w = jposes.pose_spherical(40.0, -30.0, 4.0)[:3, :4]
    o, d = rays.get_rays(H, W, 9.5, c2w, focal_scale=focal_scale, device=CPU)
    jo, jd = jrays.get_rays(H, W, 9.5, jnp.asarray(c2w), focal_scale=focal_scale)
    assert o.shape == d.shape == (H, W, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=GEOM_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=GEOM_TOL)


def test_plucker_rays(rng):
    o, d = _rays(rng)
    got = rays.plucker_rays(torch.from_numpy(o), torch.from_numpy(d)).numpy()
    want = np.asarray(jrays.plucker_rays(jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_allclose(got, want, atol=GEOM_TOL)


@pytest.mark.parametrize("n", [1, 4, 16, 64])
def test_linear_zvals_bitwise(n):
    got = sampling.linear_zvals(2.0, 6.0, n, device=CPU).numpy()
    want = np.asarray(jsamp.linear_zvals(2.0, 6.0, n))
    np.testing.assert_array_equal(got, want)


def test_sample_ray_points(rng):
    o, d = _rays(rng)
    got = ray_sampler.sample_ray_points(torch.from_numpy(o), torch.from_numpy(d),
                                        2.0, 6.0, 16).numpy()
    want = np.asarray(jrs.sample_ray_points(jnp.asarray(o), jnp.asarray(d),
                                            2.0, 6.0, 16))
    assert got.shape == (13, 48)
    np.testing.assert_allclose(got, want, atol=GEOM_TOL)


def test_sample_ray_points_perturb_waits_for_training_slice(rng):
    o, d = _rays(rng)
    with pytest.raises(NotImplementedError, match="slice 2"):
        ray_sampler.sample_ray_points(torch.from_numpy(o), torch.from_numpy(d),
                                      2.0, 6.0, 4, perturb=True)


@pytest.mark.parametrize("plucker", [False, True])
def test_sample_image_points(plucker):
    c2w = jposes.pose_spherical(-20.0, -40.0, 4.0)[:3, :4]
    got = ray_sampler.sample_image_points(c2w, 6, 8, 7.0, 2.0, 6.0, 4,
                                          plucker=plucker, device=CPU).numpy()
    want = np.asarray(jrs.sample_image_points(jnp.asarray(c2w), 6, 8, 7.0, 2.0,
                                              6.0, 4, plucker=plucker))
    assert got.shape == want.shape == (48, 6 if plucker else 12)
    # a few ulps of geometry, scaled by depths up to 6
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("include_input", [True, False])
def test_ray_embed(fast, include_input, rng):
    o, d = _rays(rng)
    x = np.array(jrs.sample_ray_points(jnp.asarray(o), jnp.asarray(d),
                                         2.0, 6.0, 6))
    got = encoding.ray_embed(torch.from_numpy(x), 10, include_input, fast).numpy()
    want = np.asarray(jenc.ray_embed(jnp.asarray(x), 10, include_input, fast))
    assert got.shape == want.shape == (13, encoding.ray_embed_dim(18, 10, include_input))
    np.testing.assert_allclose(got, want, atol=EMBED_TOL)


def test_entry_points_need_device_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rays.get_rays(4, 4, 3.0, np.eye(4, dtype=np.float32)[:3, :4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sampling.linear_zvals(2.0, 6.0, 4)
