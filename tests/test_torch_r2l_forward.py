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
from efficient_nerf_tpu_torch.ops import r2l_train as rt
from efficient_nerf_tpu_torch.ops._build import load_kernels

N_SAMPLE, L, DEPTH, WIDTH = 4, 10, 6, 64
IN_DIM = N_SAMPLE * 3 * (2 * L + 1)   # 252: not a multiple of 16, so padded
B = 40                                 # not a multiple of any tile
# Batches at the edges of the card's 64-ray tile: one ray, part of a tile,
# one tile, one ray past it, three tiles, and many
RAGGED_B = (1, 37, 64, 65, 192)
CARD_B = RAGGED_B + (8192,)
# Inputs wider than the card's shared memory holds beside the weight ring
# at once (1024 embed columns at W256, 1408 at W128), so that its head runs
# in parts: (width, n_sample) at L 10, in_pad 1280 and 1536
WIDE = ((256, 20), (128, 24), (256, 24))
# f32 operands on both sides; the double-angle embed carries ~2^L ulp
# (~1e-4) of phase error that the net may amplify: the precedent of
# tests/test_ops.py:64 for the same kernel in interpret mode
TOL = 2e-4
# (width, in_pad) -> (nt, parts, per_panel): the tile's instantiation. Each
# warpgroup owns nt = width padded to 64, halved, output columns; the
# per-panel body where those are whole 64-column panels (widths 65-128 and
# 193-256); the head in parts past the embed's room beside the weight ring
# (1024 columns at W256, 1408 at W128, 1216 at W192, 1600 at W64)
TILE_KINDS = [((256, 1024), (128, False, True)), ((256, 1088), (128, True, True)),
              ((224, 1280), (128, True, True)), ((192, 1216), (96, False, False)),
              ((192, 1280), (96, True, False)), ((160, 256), (96, False, False)),
              ((128, 1408), (64, False, True)), ((128, 1536), (64, True, True)),
              ((96, 256), (64, False, True)), ((64, 1600), (32, False, False)),
              ((32, 1664), (32, True, False))]
# widths of the card tests and whether they take the per-panel body
PER_PANEL = ((256, True), (96, True), (64, False), (160, False))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _setup(use_residual, rng, width=WIDTH, depth=DEPTH, n_sample=N_SAMPLE):
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    in_dim = n_sample * 3 * (2 * L + 1)
    jm = JaxR2LNet(input_dim=in_dim, depth=depth, width=width,
                   use_residual=use_residual)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, in_dim)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)
                   ).astype(np.float32), p)
    tm = R2LNet(in_dim, depth, width, use_residual=use_residual
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


@pytest.mark.parametrize("n_rays", RAGGED_B)
@pytest.mark.parametrize("use_residual", [False, True])
def test_plain_version_matches_pallas_interpret_ragged(use_residual, n_rays, rng):
    """The contract the card tests hold the kernel to, at the batches at
    the tile's edges."""
    _, params, tm, _, _ = _setup(use_residual, rng)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    want = np.asarray(jfwd.r2l_forward_fused(
        params, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, N_SAMPLE, L,
        dtype=jnp.float32, interpret=True, fast_embed=True, tile_b=16,
        use_global_residual=use_residual))
    packed = fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L,
                                  dtype=torch.float32)
    got = fwd.r2l_forward_fused(packed, torch.from_numpy(o), torch.from_numpy(d),
                                2.0, 6.0, N_SAMPLE, L,
                                use_global_residual=use_residual).numpy()
    assert got.shape == (n_rays, 3)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("n_sample", sorted({n for _, n in WIDE}))
def test_plain_version_matches_pallas_interpret_wide_input(n_sample, rng):
    """The contract the card tests hold the kernel to at inputs whose head
    the card runs in parts."""
    _, params, tm, o, d = _setup(True, rng, n_sample=n_sample)
    want = np.asarray(jfwd.r2l_forward_fused(
        params, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, n_sample, L,
        dtype=jnp.float32, interpret=True, fast_embed=True, tile_b=16,
        use_global_residual=True))
    packed = fwd.pack_r2l_weights(tm.state_dict(), n_sample, L,
                                  dtype=torch.float32)
    assert packed["head_w"].shape[1] == -(-n_sample * 3 * (2 * L + 1) // 64) * 64
    got = fwd.r2l_forward_fused(packed, torch.from_numpy(o), torch.from_numpy(d),
                                2.0, 6.0, n_sample, L,
                                use_global_residual=True).numpy()
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


@pytest.mark.parametrize("shape,want", TILE_KINDS, ids=[f"W{w}-in{i}" for (w, i), _ in TILE_KINDS])
def test_tile_kind_follows_the_widths(shape, want):
    assert tuple(fwd.tile_kind(*shape)) == want


def _card_model(rng, width, depth, use_residual, dev, n_sample=N_SAMPLE):
    # lecun-normal kernels with each block's second linear times 0.1, small
    # biases: the outputs stay clear of the sigmoid's flat ends (the init of
    # perfbench/configs/r2l_w256d88.json)
    tm = R2LNet(n_sample * 3 * (2 * L + 1), depth, width, use_residual=use_residual)
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            if ".body.2.weight" in name:
                scale *= 0.1
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    return fwd.pack_r2l_weights({k: v.to(dev) for k, v in tm.state_dict().items()},
                                n_sample, L)


def _card_check(packed, n_rays, use_residual, dev, rng, n_sample=N_SAMPLE):
    ro = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32)).to(dev)
    rd = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32)).to(dev)
    launches = fwd.r2l_forward_fused.launches
    got = fwd.r2l_forward_fused(packed, ro, rd, 2.0, 6.0, n_sample, L,
                                use_global_residual=use_residual)
    again = fwd.r2l_forward_fused(packed, ro, rd, 2.0, 6.0, n_sample, L,
                                  use_global_residual=use_residual)
    torch.cuda.synchronize()
    assert fwd.r2l_forward_fused.launches == launches + 2
    assert torch.equal(got, again)  # no atomics, no order that changes
    want = fwd.r2l_forward_fused_ref(packed, ro, rd, 2.0, 6.0, n_sample, L,
                                     use_global_residual=use_residual)
    # same bf16 operands and f32 epilogues; only the summation order differs,
    # and a one-ulp difference can flip a bf16 rounding: chip_smoke.py's
    # KERNEL_TOL, set from that noise measured at 88 layers (PERF.md)
    torch.testing.assert_close(got, want, atol=4e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", CARD_B)
@pytest.mark.parametrize("use_residual", [False, True])
def test_kernel_matches_plain_version(use_residual, n_rays, cuda_device, rng):
    packed = _card_model(rng, 256, 12, use_residual, cuda_device)
    _card_check(packed, n_rays, use_residual, cuda_device, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 96, 160])
def test_kernel_pads_other_widths(width, cuda_device, rng):
    """Widths that are not a multiple of 64 run on zero padding (rows and
    columns past W land as zeros); with 256 these cover the kernel's four
    warpgroup widths."""
    packed = _card_model(rng, width, 6, True, cuda_device)
    _card_check(packed, 65, True, cuda_device, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_sample", WIDE)
@pytest.mark.parametrize("use_residual", [False, True])
def test_kernel_runs_wide_inputs_in_parts(use_residual, width, n_sample, cuda_device,
                                          rng):
    """Inputs of 1280 and 1536 columns, whose embed the kernel writes and
    contracts in parts with the head's sums carried across them."""
    packed = _card_model(rng, width, 6, use_residual, cuda_device, n_sample)
    _card_check(packed, 192, use_residual, cuda_device, rng, n_sample)


@pytest.mark.cuda
@pytest.mark.parametrize("width,per_panel", PER_PANEL)
def test_kernel_takes_the_per_panel_body_by_width(width, per_panel, cuda_device, rng):
    """W256 and W96 run the body on per-panel barriers, W64 and W160 on a
    block barrier a layer: the launches counted as such, and right."""
    packed = _card_model(rng, width, 6, True, cuda_device)
    panel = fwd.r2l_forward_fused.panel_launches
    _card_check(packed, 65, True, cuda_device, rng)
    assert fwd.r2l_forward_fused.panel_launches - panel == (2 if per_panel else 0)


@pytest.mark.cuda
def test_tile_kind_is_the_launchers(cuda_device):
    """tile_kind, which the counters read, is the choice of the launchers of
    kernels 1 and 3a (csrc/r2l_wgmma.cuh's tile_kind) at every width."""
    libs = ((load_kernels("r2l_forward", fwd._SIGNATURES), "r2l_forward_tile_kind"),
            (load_kernels("r2l_train", rt._SIGNATURES), "r2l_train_fwd_tile_kind"))
    for width in range(32, 257, 32):
        for in_pad in (256, 1024, 1088, 1216, 1280, 1408, 1472, 1600, 1664):
            kind = fwd.tile_kind(width, in_pad)
            for lib, name in libs:
                assert getattr(lib, name)(in_pad, width) == kind.parts | kind.per_panel << 1, \
                    (name, width, in_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("use_residual", [False, True])
def test_kernel_repeats_its_bits_on_a_frame(use_residual, cuda_device, rng):
    """A 400x400 frame's 160,000 rays at the serving shape (W256 D88, 16
    samples), with and without the global residual: two calls give the same
    bits, whichever warpgroup reaches a panel first, and agree with the
    plain version."""
    packed = _card_model(rng, 256, 88, use_residual, cuda_device, n_sample=16)
    panel = fwd.r2l_forward_fused.panel_launches
    _card_check(packed, 160_000, use_residual, cuda_device, rng, n_sample=16)
    assert fwd.r2l_forward_fused.panel_launches == panel + 2
