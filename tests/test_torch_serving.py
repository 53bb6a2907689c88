"""The port's serving entry points against the JAX package's on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core.poses import pose_spherical
from efficient_nerf_tpu.models import R2LNet as JaxR2LNet
from efficient_nerf_tpu.render import r2l_renderer as jren
from efficient_nerf_tpu_torch.models import R2LNet
from efficient_nerf_tpu_torch.render import (make_r2l_forward, r2l_forward_rays,
                                             r2l_render_image)

N_SAMPLE, L, DEPTH, WIDTH = 4, 10, 6, 32
NEAR, FAR, H, W, FOCAL = 2.0, 6.0, 8, 8, 9.0
# Both sides run the unfused path in f32 with the exact embed at up to 2^9 x
# |p| rad; a one-ulp difference in a sample point moves a top-octave feature
# by ~1e-4, which the net carries to the output at about the same size.
TOL = 1e-4


def _models(plucker, rng):
    input_dim = (6 if plucker else 3 * N_SAMPLE) * (2 * L + 1)
    jm = JaxR2LNet(input_dim=input_dim, depth=DEPTH, width=WIDTH)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, input_dim)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)
                   ).astype(np.float32), p)
    return jm, params, R2LNet(input_dim, DEPTH, WIDTH).load_jax_params(params)


@pytest.mark.parametrize("plucker", [False, True])
def test_forward_rays_matches_jax(plucker, rng):
    jm, params, tm = _models(plucker, rng)
    o = rng.normal(size=(37, 3)).astype(np.float32)
    d = rng.normal(size=(37, 3)).astype(np.float32)
    want = np.asarray(jren.r2l_forward_rays(jm, params, jnp.asarray(o),
                                            jnp.asarray(d), NEAR, FAR,
                                            N_SAMPLE, L, plucker=plucker))
    got = r2l_forward_rays(tm, o, d, NEAR, FAR, N_SAMPLE, L, plucker=plucker,
                           device="cpu")
    assert got.shape == (37, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    fn = make_r2l_forward(tm, NEAR, FAR, N_SAMPLE, L, plucker=plucker,
                          device="cpu")
    np.testing.assert_array_equal(fn(o, d).numpy(), got.numpy())


@pytest.mark.parametrize("chunk", [0, 24])
@pytest.mark.parametrize("plucker", [False, True])
def test_render_image_matches_jax(plucker, chunk, rng):
    jm, params, tm = _models(plucker, rng)
    c2w = pose_spherical(45.0, -30.0, 4.0)[:3, :4]
    want = np.asarray(jren.r2l_render_image(jm, params, jnp.asarray(c2w), H, W,
                                            FOCAL, NEAR, FAR, N_SAMPLE, L,
                                            plucker=plucker, chunk=chunk))
    got = r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L,
                           plucker=plucker, chunk=chunk, device="cpu")
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_entry_points_raise_without_device_when_cuda_is_absent(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    _, _, tm = _models(False, rng)
    o = np.zeros((4, 3), np.float32)
    c2w = pose_spherical(0.0, -30.0, 4.0)[:3, :4]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_r2l_forward(tm, NEAR, FAR, N_SAMPLE, L)


def test_int8_and_unknown_quant_raise(rng):
    _, _, tm = _models(False, rng)
    o = np.zeros((4, 3), np.float32)
    c2w = pose_spherical(0.0, -30.0, 4.0)[:3, :4]
    with pytest.raises(NotImplementedError, match="slice 3"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L, quant="int8",
                         device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L,
                         quant="int8", device="cpu")
    with pytest.raises(ValueError, match="quant"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L, quant="fp8",
                         device="cpu")


def test_other_model_types_raise():
    conv = torch.nn.Conv2d(3, 3, 1)
    with pytest.raises(NotImplementedError, match="R2LConvNet"):
        r2l_render_image(conv, np.eye(4)[:3], H, W, FOCAL, NEAR, FAR,
                         N_SAMPLE, L, device="cpu")


def test_model_on_another_device_raises(rng):
    _, _, tm = _models(False, rng)
    o = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="model.to"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L, device="meta")
