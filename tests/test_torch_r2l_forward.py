"""The fused R2L forward's plain version (what the wrapper runs on CPU
tensors) against the JAX Pallas kernel in interpret mode and against the flax
forward; the CUDA kernel against the plain version on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core.encoding import ray_embed
from efficient_nerf_tpu.core.ray_sampler import sample_ray_points
from efficient_nerf_tpu.ops.pallas import r2l_forward as jfwd
from efficient_nerf_tpu_torch.models import R2LNet
from efficient_nerf_tpu_torch.ops import r2l_forward as fwd

N_SAMPLE, L, DEPTH, WIDTH = 4, 10, 6, 64
IN_DIM = N_SAMPLE * 3 * (2 * L + 1)   # 252: not a multiple of 16, so padded
B = 40                                 # not a multiple of any tile
# f32 operands on both sides; the double-angle embed carries ~2^L ulp
# (~1e-4) of phase error that the net may amplify: the precedent of
# tests/test_ops.py:64 for the same kernel in interpret mode
TOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _setup(use_residual, rng, width=WIDTH, depth=DEPTH):
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    jm = JaxR2LNet(input_dim=IN_DIM, depth=depth, width=width,
                   use_residual=use_residual)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IN_DIM)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)
                   ).astype(np.float32), p)
    tm = R2LNet(IN_DIM, depth, width, use_residual=use_residual
                ).load_jax_params(params)
    o = rng.normal(size=(B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    return jm, params, tm, o, d


@pytest.mark.parametrize("use_residual", [False, True])
def test_plain_version_matches_pallas_interpret(use_residual, rng):
    jm, params, tm, o, d = _setup(use_residual, rng)
    want = np.asarray(jfwd.r2l_forward_fused(
        params, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, N_SAMPLE, L,
        dtype=jnp.float32, interpret=True, fast_embed=True, tile_b=16,
        use_global_residual=use_residual))
    packed = fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L,
                                  dtype=torch.float32)
    launches = fwd.r2l_forward_fused.launches
    got = fwd.r2l_forward_fused(packed, torch.from_numpy(o), torch.from_numpy(d),
                                2.0, 6.0, N_SAMPLE, L,
                                use_global_residual=use_residual).numpy()
    assert fwd.r2l_forward_fused.launches == launches  # CPU: no kernel launch
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("use_residual", [False, True])
def test_plain_version_matches_flax(use_residual, rng):
    jm, params, tm, o, d = _setup(use_residual, rng)
    x = ray_embed(sample_ray_points(jnp.asarray(o), jnp.asarray(d), 2.0, 6.0,
                                    N_SAMPLE), L)
    want = np.asarray(jm.apply({"params": params}, x))
    packed = fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L,
                                  dtype=torch.float32)
    got = fwd.r2l_forward_fused_ref(packed, torch.from_numpy(o),
                                    torch.from_numpy(d), 2.0, 6.0, N_SAMPLE, L,
                                    use_global_residual=use_residual).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_head_perm_matches_jax_and_is_a_permutation():
    perm = fwd._doubling_head_perm_np(16, 10)
    np.testing.assert_array_equal(perm, jfwd._doubling_head_perm_np(16, 10))
    np.testing.assert_array_equal(np.sort(perm), np.arange(1008))


def test_pack_layout(rng):
    _, params, tm, _, _ = _setup(False, rng)
    packed = fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L)
    in_pad = 256  # 252 rounded up to 64
    # nn.Linear's [out, in] layout; the head's input columns permuted
    assert packed["head_w"].shape == (WIDTH, in_pad)
    assert packed["head_w"].dtype == torch.bfloat16
    assert torch.all(packed["head_w"][:, IN_DIM:] == 0)
    perm = fwd._doubling_head_perm_np(N_SAMPLE, L)
    np.testing.assert_array_equal(
        packed["head_w"][:, :IN_DIM].float().numpy(),
        torch.from_numpy(params["head"]["kernel"][perm].T).bfloat16().float().numpy())
    nb = (DEPTH - 2) // 2
    assert packed["body_w"].shape == (nb, 2, WIDTH, WIDTH)
    np.testing.assert_array_equal(
        packed["body_w"][1, 1].float().numpy(),
        torch.from_numpy(params["body"]["lin_1"]["kernel"][1].T).bfloat16().float().numpy())
    assert packed["body_b"].shape == (nb, 2, WIDTH)
    assert packed["tail_w"].shape == (3, WIDTH)
    assert fwd.r2l_forward_flops(packed, 10) == 2 * 10 * (
        IN_DIM * WIDTH + 2 * nb * WIDTH * WIDTH + WIDTH * 3)


def test_pack_rejects_other_profiles(rng):
    tm = R2LNet(IN_DIM, DEPTH, WIDTH, linear_tail=True)
    with pytest.raises(ValueError, match="sigmoid-tail"):
        fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L)
    tm = R2LNet(IN_DIM, DEPTH, WIDTH)
    with pytest.raises(ValueError, match="n_sample"):
        fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE + 1, L)
    packed = fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L)
    o = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="packed for"):
        fwd.r2l_forward_fused(packed, o, o, 2.0, 6.0, N_SAMPLE, L - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("use_residual", [False, True])
def test_kernel_matches_plain_version(use_residual, cuda_device, rng):
    # lecun-normal kernels with each block's second linear times 0.1, small
    # biases: the outputs stay clear of the sigmoid's flat ends (chip_smoke.py)
    tm = R2LNet(IN_DIM, 12, 256, use_residual=use_residual)
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            if ".body.2.weight" in name:
                scale *= 0.1
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    o = rng.normal(size=(B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    packed = fwd.pack_r2l_weights(
        {k: v.to(cuda_device) for k, v in tm.state_dict().items()}, N_SAMPLE, L)
    ro = torch.from_numpy(o).to(cuda_device)
    rd = torch.from_numpy(d).to(cuda_device)
    launches = fwd.r2l_forward_fused.launches
    got = fwd.r2l_forward_fused(packed, ro, rd, 2.0, 6.0, N_SAMPLE, L,
                                use_global_residual=use_residual)
    torch.cuda.synchronize()
    assert fwd.r2l_forward_fused.launches == launches + 1
    want = fwd.r2l_forward_fused_ref(packed, ro, rd, 2.0, 6.0, N_SAMPLE, L,
                                     use_global_residual=use_residual)
    # same bf16 operands and f32 epilogues; only the summation order differs,
    # and a one-ulp difference can flip a bf16 rounding: chip_smoke.py's
    # tolerance, set from that noise at 88 layers (PERF.md)
    torch.testing.assert_close(got, want, atol=4e-3, rtol=0)
