"""The teacher field eval: the port's NeRFMLP against the flax NeRFMLP, the
packed operands against the Pallas pack, the plain version of the fused
kernel (what the wrapper runs on CPU tensors) against the Pallas kernel in
interpret mode; the CUDA kernel against the plain version on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core.encoding import nerf_embed as jax_nerf_embed
from efficient_nerf_tpu.ops.pallas import nerf_forward as jnf
from efficient_nerf_tpu_torch.models import NeRFMLP, nerf_state_dict_from_params
from efficient_nerf_tpu_torch.models.weights import nerf_params_from_state_dict
from efficient_nerf_tpu_torch.ops import nerf_forward as nf

L, LV, DEPTH, WIDTH = 10, 4, 8, 64
# f32 operands on both sides: the JAX package's own tolerance for this
# kernel in interpret mode against flax (tests/test_ops.py:94)
TOL = 3e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _params(rng, depth=DEPTH, width=WIDTH):
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=depth, width=width)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 90)))["params"]
    # perturbed so that biases are not zero
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.05, size=v.shape)
                   ).astype(np.float32), p)
    return jm, params, NeRFMLP(depth=depth, width=width).load_jax_params(params)


def _inputs(rng, N, S):
    pts = rng.normal(size=(N, S, 3)).astype(np.float32)
    vd = rng.normal(size=(N, 3)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True)


@pytest.mark.parametrize("fast", [False, True])
def test_nerfmlp_matches_flax(fast, rng):
    jm, params, tm = _params(rng)
    pts, vd = _inputs(rng, 6, 5)
    emb = jax_nerf_embed(jnp.asarray(pts), L, fast=fast)
    de = jnp.broadcast_to(jax_nerf_embed(jnp.asarray(vd), LV, fast=fast)[:, None],
                          (6, 5, 27))
    x = jnp.concatenate([emb, de], -1)
    want = np.asarray(jm.apply({"params": params}, x))
    got = tm(torch.from_numpy(np.array(x))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_nerfmlp_without_viewdirs_matches_flax(rng):
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=4, width=32, skips=(1,), use_viewdirs=False)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 63)))["params"]
    tm = NeRFMLP(depth=4, width=32, skips=(1,), use_viewdirs=False
                 ).load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    x = rng.normal(size=(5, 63)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (5, 4) and "output_linear.weight" in tm.state_dict()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_state_dict_round_trip(rng):
    _, params, tm = _params(rng)
    back = nerf_params_from_state_dict(tm.state_dict())
    for name, leaf in params.items():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][k], leaf[k])
    sd = nerf_state_dict_from_params(params)
    assert set(sd) == set(tm.state_dict())
    # the module's own keys: the reference NeRF layout
    assert "views_linears.0.weight" in sd and "pts_linears.5.weight" in sd
    assert tm.state_dict()["pts_linears.5.weight"].shape == (WIDTH, WIDTH + 63)


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_pack_matches_jax_bitwise(dtype, jdtype, rng):
    _, params, tm = _params(rng)
    want = jnf.pack_nerf_weights(params, skip=4, dtype=jdtype)
    got = nf.pack_nerf_weights(tm.state_dict(), skip=4, dtype=dtype)

    def eq(a, b):  # torch [out, in] against JAX [in, out], bit for bit
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b).astype(np.float32))

    ic = got["in_ch"]
    assert got["pts0_w"].shape == (WIDTH, 64) and got["pts0_w"].dtype == dtype
    assert torch.all(got["pts0_w"][:, ic:] == 0)
    eq(got["pts0_w"][:, :ic].t(), want["pts0_w"])
    eq(got["skip_x_w"][:, :ic].t(), want["skip_x_w"])
    eq(got["body_w"].transpose(1, 2), want["body_w"])
    for k in ("pts0_b", "body_b", "feat_b", "views_b"):
        eq(got[k], want[k])
    eq(got["feat_w"].t(), want["feat_w"])
    eq(got["views_h_w"].t(), want["views_h_w"])
    eq(got["views_d_w"].t(), want["views_d_w"])
    eq(got["rgb_w"].t(), np.asarray(want["out_w_hv"])[:, :3])
    eq(got["alpha_w"], np.asarray(want["out_w_h"])[:, 3])
    np.testing.assert_array_equal(got["out_b"].numpy(), np.asarray(want["out_b"])[:4])
    for k in ("depth", "skip", "width", "half", "in_ch", "in_ch_views"):
        assert got[k] == want[k], k


def test_embed_constants_match_jax():
    for got, want in zip(nf.nerf_embed_constants(L),
                         jnf._nerf_embed_constants_np(L)):
        np.testing.assert_array_equal(got, want)


def test_dirs_embed_matches_jax_bitwise(rng):
    _, vd = _inputs(rng, 33, 1)
    want = np.asarray(jnf._linearized_embed(jnp.asarray(vd), LV))
    got = nf.embed_dirs(torch.from_numpy(vd), LV).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,S", [(7, 5), (3, 16), (11, 3)])   # ragged N * S
@pytest.mark.parametrize("cm", [False, True])
def test_plain_version_matches_pallas_interpret_f32(N, S, cm, rng):
    _, params, tm = _params(rng)
    pts, vd = _inputs(rng, N, S)
    want = np.asarray(jnf.nerf_forward_fused(
        params, jnp.asarray(pts), jnp.asarray(vd), L, LV, tile_p=16,
        dtype=jnp.float32, interpret=True))
    packed = nf.pack_nerf_weights(tm.state_dict(), dtype=torch.float32)
    tp = torch.from_numpy(pts)
    launches = nf.nerf_forward_fused.launches
    got = nf.nerf_forward_fused(packed, tp.permute(2, 0, 1).contiguous() if cm else tp,
                                torch.from_numpy(vd), L, LV, cm=cm).numpy()
    assert nf.nerf_forward_fused.launches == launches  # CPU: no kernel launch
    if cm:
        assert got.shape == (4, N, S)
        got = np.moveaxis(got, 0, -1)
    assert got.shape == (N, S, 4)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_plain_version_matches_pallas_interpret_bf16(rng):
    """bf16 operands, bf16 inner biases, feat rounded to bf16 on both sides:
    the same roundings of sums that differ only in order; measured to agree
    to 6e-8 at this size. 1e-3 leaves room for a one-ulp bf16 flip."""
    _, params, tm = _params(rng)
    pts, vd = _inputs(rng, 9, 7)
    want = np.asarray(jnf.nerf_forward_fused(
        params, jnp.asarray(pts), jnp.asarray(vd), L, LV, tile_p=16,
        dtype=jnp.bfloat16, interpret=True))
    packed = nf.pack_nerf_weights(tm.state_dict())
    got = nf.nerf_forward_fused(packed, torch.from_numpy(pts),
                                torch.from_numpy(vd), L, LV).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_plain_version_matches_flax(rng):
    """The plain version at f32 against the flax forward on nerf_embed: the
    phased fast_sin embed is ~1e-6 from sin/cos (tests/test_ops.py:94)."""
    jm, params, tm = _params(rng)
    pts, vd = _inputs(rng, 5, 9)
    emb = jax_nerf_embed(jnp.asarray(pts), L)
    de = jnp.broadcast_to(jax_nerf_embed(jnp.asarray(vd), LV)[:, None], (5, 9, 27))
    want = np.asarray(jm.apply({"params": params}, jnp.concatenate([emb, de], -1)))
    packed = nf.pack_nerf_weights(tm.state_dict(), dtype=torch.float32)
    got = nf.nerf_forward_fused_ref(packed, torch.from_numpy(pts),
                                    torch.from_numpy(vd), L, LV).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_flops_and_checks(rng):
    tm = NeRFMLP(depth=DEPTH, width=WIDTH)
    packed = nf.pack_nerf_weights(tm.state_dict())
    W, h = WIDTH, WIDTH // 2
    assert nf.nerf_forward_flops(packed, 10, 2) == 2 * (
        10 * (2 * 63 * W + 7 * W * W + W + W * W + W * h + h * 3) + 2 * 27 * h)
    pts = torch.zeros(2, 3, 3)
    with pytest.raises(ValueError, match="columns"):
        nf.nerf_forward_fused(packed, pts, torch.zeros(2, 3), L - 1, LV)
    with pytest.raises(ValueError, match="viewdirs"):
        nf.nerf_forward_fused(packed, pts, torch.zeros(3, 3), L, LV)
    with pytest.raises(ValueError, match="pts"):
        nf.nerf_forward_fused(packed, torch.zeros(2, 3, 2), torch.zeros(2, 3), L, LV)
    with pytest.raises(ValueError, match="viewdir teacher"):
        nf.pack_nerf_weights(NeRFMLP(depth=4, width=32, use_viewdirs=False).state_dict())
    with pytest.raises(ValueError, match="skip"):
        nf.pack_nerf_weights(tm.state_dict(), skip=5)


def _card_teacher(rng, width=256, depth=8, L=L, LV=LV, skip=4):
    """A random teacher with lecun-normal kernels and small biases (the
    init of perfbench/configs/nerf_lego.json)."""
    tm = NeRFMLP(depth=depth, width=width, input_ch=3 * (2 * L + 1),
                 input_ch_views=3 * (2 * LV + 1), skips=(skip,))
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    return tm


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,cm", [(20, 64, False), (9, 192, False),
                                    (37, 64, True), (5, 16, False)])
def test_kernel_matches_plain_version(N, S, cm, cuda_device, rng):
    tm = _card_teacher(rng)
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in
                                   tm.state_dict().items()})
    pts, vd = _inputs(rng, N, S)
    tp = torch.from_numpy(pts * 1.5).to(cuda_device)
    if cm:
        tp = tp.permute(2, 0, 1).contiguous()
    tv = torch.from_numpy(vd).to(cuda_device)
    launches = nf.nerf_forward_fused.launches
    got = nf.nerf_forward_fused(packed, tp, tv, L, LV, cm=cm)
    torch.cuda.synchronize()
    assert nf.nerf_forward_fused.launches == launches + 1
    want = nf.nerf_forward_fused_ref(packed, tp, tv, L, LV, cm=cm)
    # same bf16 operands; the sums run in another order, and a one-ulp
    # difference can flip a bf16 rounding of an activation: relative to the
    # largest magnitude, chip_smoke.py's TEACHER_TOL
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 2e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("width,depth,L_pts,L_dirs", [(64, 8, 10, 4), (128, 6, 6, 2)])
def test_kernel_matches_plain_version_other_shapes(width, depth, L_pts, L_dirs,
                                                   cuda_device, rng):
    """Narrower widths (fewer warps own columns), another depth and other
    embed widths (39 point columns padded to 64, 15 direction columns)."""
    tm = _card_teacher(rng, width, depth, L_pts, L_dirs)
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in
                                   tm.state_dict().items()})
    pts, vd = _inputs(rng, 11, 24)
    tp = torch.from_numpy(pts).to(cuda_device)
    tv = torch.from_numpy(vd).to(cuda_device)
    got = nf.nerf_forward_fused(packed, tp, tv, L_pts, L_dirs)
    want = nf.nerf_forward_fused_ref(packed, tp, tv, L_pts, L_dirs)
    torch.cuda.synchronize()
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 2e-2, err


def _card_error(packed, N, S, rng, cuda_device, cm=False, L_pts=L, L_dirs=LV):
    """max |kernel - plain| / max |plain| on N x S random points (the raw
    relative to its largest magnitude)."""
    pts, vd = _inputs(rng, N, S)
    tp = torch.from_numpy(pts * 1.5).to(cuda_device)
    if cm:
        tp = tp.permute(2, 0, 1).contiguous()
    tv = torch.from_numpy(vd).to(cuda_device)
    got = nf.nerf_forward_fused(packed, tp, tv, L_pts, L_dirs, cm=cm)
    want = nf.nerf_forward_fused_ref(packed, tp, tv, L_pts, L_dirs, cm=cm)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return ((got - want).abs().max() / want.abs().max()).item()


# The wgmma tile's edges: 5 and 60 points (the second warpgroup has no row),
# 100 (it has part of one), point counts that are not a multiple of 128,
# tiles that straddle up to 64 rays (S = 1) or 4 (S = 37), and 1050 tiles,
# which the persistent blocks take several each; and the renderer's coarse
# and fine chunks of the lego config (32,768 rays x 64 and x 192)
@pytest.mark.cuda
@pytest.mark.parametrize("N,S,cm", [(1, 5, False), (3, 20, False), (1, 100, True),
                                    (7, 37, False), (200, 1, False), (333, 1, True),
                                    (3, 64, False), (5, 192, True), (700, 192, False),
                                    (32768, 64, False), (32768, 192, False)])
def test_tile_edges_match_plain_version(N, S, cm, cuda_device, rng):
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in
                                   _card_teacher(rng).state_dict().items()})
    assert _card_error(packed, N, S, rng, cuda_device, cm) <= 2e-2


# W128 and W192 (their own wgmma widths), another depth and skip at W256
@pytest.mark.cuda
@pytest.mark.parametrize("width,depth,skip", [(128, 8, 4), (192, 8, 4), (256, 6, 2),
                                              (128, 10, 7)])
def test_tile_widths_and_depths_match_plain_version(width, depth, skip, cuda_device, rng):
    tm = _card_teacher(rng, width, depth, skip=skip)
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in tm.state_dict().items()},
                                  skip=skip)
    for N, S in ((37, 64), (9, 192)):
        assert _card_error(packed, N, S, rng, cuda_device) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", [(37, 64), (300, 192), (32768, 64), (32768, 192)])
def test_kernel_two_calls_same_bits(N, S, cuda_device, rng):
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in
                                   _card_teacher(rng).state_dict().items()})
    pts, vd = _inputs(rng, N, S)
    tp, tv = torch.from_numpy(pts).to(cuda_device), torch.from_numpy(vd).to(cuda_device)
    first = nf.nerf_forward_fused(packed, tp, tv, L, LV)
    assert torch.equal(first, nf.nerf_forward_fused(packed, tp, tv, L, LV))
