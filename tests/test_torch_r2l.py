"""The port's R2LNet, with weights carried across from flax params, against
flax R2LNet.apply; the weight converters' round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.models import R2LNet as JaxR2LNet
from efficient_nerf_tpu.models.torch_import import r2l_state_dict_from_params
from efficient_nerf_tpu_torch.models import (R2LNet, r2l_params_from_state_dict,
                                             r2l_state_dict_from_jax)
from efficient_nerf_tpu_torch.models import weights

# f32 on both sides; a depth-6 width-32 net sums in another order on each
# side: differences of a few ulps of O(1) activations
TOL = 1e-5


def _jax_params(model, input_dim, rng):
    """flax init, then numpy noise on every leaf so that biases are nonzero."""
    p = model.init(jax.random.PRNGKey(0), jnp.zeros((1, input_dim)))["params"]
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.05, size=v.shape)
                   ).astype(np.float32), p)


@pytest.mark.parametrize("linear_tail", [False, True])
@pytest.mark.parametrize("res_scale", [1.0, 0.5])
@pytest.mark.parametrize("use_residual", [False, True])
def test_r2lnet_matches_flax(use_residual, res_scale, linear_tail, rng):
    input_dim, depth, width = 4 * 3 * 21, 6, 32
    kw = dict(depth=depth, width=width, use_residual=use_residual,
              res_scale=res_scale, linear_tail=linear_tail)
    jm = JaxR2LNet(input_dim=input_dim, **kw)
    params = _jax_params(jm, input_dim, rng)
    x = rng.normal(size=(17, input_dim)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    tm = R2LNet(input_dim, **kw).load_jax_params(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("linear_tail", [False, True])
def test_state_dict_round_trip(linear_tail, rng):
    input_dim, depth, width = 30, 8, 16
    jm = JaxR2LNet(input_dim=input_dim, depth=depth, width=width,
                   linear_tail=linear_tail)
    params = _jax_params(jm, input_dim, rng)

    # the port's copy of the converter gives the JAX package's key layout
    sd = r2l_state_dict_from_jax(params, linear_tail=linear_tail)
    ref = r2l_state_dict_from_params(params, linear_tail=linear_tail)
    assert sd.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])

    # ... which the port's module loads, and which converts back exactly
    tm = R2LNet(input_dim, depth, width, linear_tail=linear_tail)
    tm.load_state_dict(sd)
    back = r2l_params_from_state_dict(tm.state_dict(), n_block=(depth - 2) // 2,
                                      linear_tail=linear_tail)
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, v in flat:
        np.testing.assert_array_equal(back_flat[path], np.asarray(v))
    np.testing.assert_array_equal(
        weights.r2l_state_dict_from_params(back, linear_tail=linear_tail)
        ["head.0.weight"], ref["head.0.weight"])


def test_state_dict_keys_follow_reference_layout():
    tm = R2LNet(30, depth=6, width=16)
    assert set(tm.state_dict()) == {
        "head.0.weight", "head.0.bias", "tail.0.weight", "tail.0.bias",
        *(f"body.{b}.body.{i}.{p}" for b in range(2) for i in (0, 2)
          for p in ("weight", "bias"))}


@pytest.mark.parametrize("kw", [
    # the global residual adds body layer depth - 2 (16 wide) to the head
    # (32 wide): the JAX module's apply fails to broadcast them
    dict(layerwise_widths=(32, 16, 24, 40, 16), use_residual=True),
    # fewer than depth - 2 widths: the JAX module's apply indexes past them
    dict(layerwise_widths=(32, 16, 24))])
def test_invalid_layerwise_shapes_raise(kw):
    with pytest.raises(ValueError, match="R2LNet"):
        R2LNet(30, depth=6, width=16, **kw)
