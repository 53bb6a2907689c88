"""The fused training forward and the two-pass backward: their plain versions
(what the wrappers run on CPU tensors) and the autograd Function against the
JAX Pallas kernels in interpret mode, the passes' composition and its ray
chunks; the CUDA kernels against the plain versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.ops.pallas import r2l_train as jtrain
from efficient_nerf_tpu_torch.models import R2LNet
from efficient_nerf_tpu_torch.models.weights import r2l_state_dict_from_params
from efficient_nerf_tpu_torch.ops import fused_r2l_train_available
from efficient_nerf_tpu_torch.ops import r2l_train as rt
from efficient_nerf_tpu_torch.ops.r2l_forward import _doubling_head_perm_np

N_SAMPLE, L, DEPTH, WIDTH, B = 4, 10, 8, 32, 37   # B: a ragged tile
K = 3 * N_SAMPLE
IN_DIM = K * (2 * L + 1)                          # 252, padded to 256
# f32 operands on both sides. embed_L = 0: the same products in another
# summation order, ~1e-6 relative. embed_L = 10: the fast trig of the two
# packages differs by up to 1e-5 (tests/test_torch_trig.py) and the
# double-angle recurrence amplifies that by up to 2^9; the JAX package's
# own in-kernel-embed test allows 2e-4 on out and 5e-4 of each gradient's
# largest magnitude for the same effect (tests/test_ops.py:284-321).
TOL_OUT = {0: 1e-5, 10: 2e-4}
TOL_GRAD = {0: 1e-5, 10: 5e-4}
# bf16 operands on both sides: the same roundings, but a one-ulp difference
# of an f32 sum can flip a bf16 rounding (2^-8 relative) of an activation or
# a cotangent, and that carries through the blocks.
TOL_BF16_OUT = 1e-2
TOL_BF16_GRAD = 3e-2
# Batches at the edges of the card's 64-ray tile: one ray, part of a tile,
# one tile, one ray past it, three tiles, and many
RAGGED_B = (1, 37, 64, 65, 192)
CARD_B = RAGGED_B + (8192,)
# Inputs wider than the card's shared memory holds beside the forward's
# weight ring at once (1024 embed columns at W256, 1408 at W128), so that
# its head runs in parts: (width, n_sample) at L 10, in_pad 1280 and 1536
WIDE = ((256, 20), (128, 24), (256, 24))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _setup(rng, *, grs=False, res_scale=1.0, embed_L=10, dtype=np.float32,
           depth=DEPTH, width=WIDTH, n_sample=N_SAMPLE):
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    k = 3 * n_sample
    in_dim = k * (2 * L + 1)
    jm = JaxR2LNet(input_dim=in_dim, depth=depth, width=width,
                   res_scale=res_scale, use_residual=grs, dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, in_dim)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)
                   ).astype(np.float32), p)
    tm = R2LNet(in_dim, depth, width, res_scale=res_scale, use_residual=grs,
                dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
                ).load_jax_params(params)
    if embed_L:
        x = (rng.normal(size=(B, k)) * 3.0).astype(np.float32)
    else:
        x = rng.normal(size=(B, in_dim)).astype(np.float32)
    dout = rng.normal(size=(B, 3)).astype(np.float32)
    return params, tm, x, dout


def _jax_vjp(params, x, dout, *, grs, res_scale, embed_L, need_dx, dtype):
    def f(p, xx):
        return jtrain.r2l_train_apply(
            p, xx, res_scale=res_scale, use_global_residual=grs, tile_b=16,
            tile_b_bwd=32, dtype=dtype, embed_L=embed_L, need_dx=need_dx,
            interpret=True)

    out, vjp = jax.vjp(f, params, jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(dout))
    sd = r2l_state_dict_from_params(jax.tree_util.tree_map(np.asarray, g_params))
    return np.asarray(out), sd, np.asarray(g_x)


def _launches():
    return (rt.r2l_train_fwd.launches, rt.r2l_train_bwd_act.launches,
            rt.r2l_train_wgrad.launches)


def _port_grads(tm, x, dout, embed_L, need_dx):
    xt = torch.from_numpy(x).requires_grad_(need_dx)
    out = rt.r2l_train_apply(tm, xt, embed_L=embed_L, need_dx=need_dx)
    out.backward(torch.from_numpy(dout))
    grads = {k: v.grad.numpy() for k, v in tm.named_parameters()}
    return out.detach().numpy(), grads, (xt.grad.numpy() if need_dx else None)


def _assert_grads(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(got[k], w, atol=tol * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("embed_L", [0, 10])
@pytest.mark.parametrize("grs,res_scale", [(False, 1.0), (True, 0.5)])
def test_function_matches_pallas_interpret_f32(grs, res_scale, embed_L, need_dx,
                                               rng):
    params, tm, x, dout = _setup(rng, grs=grs, res_scale=res_scale,
                                 embed_L=embed_L)
    out_w, g_w, dx_w = _jax_vjp(params, x, dout, grs=grs, res_scale=res_scale,
                                embed_L=embed_L, need_dx=need_dx,
                                dtype=jnp.float32)
    launches = _launches()
    out, grads, dx = _port_grads(tm, x, dout, embed_L, need_dx)
    assert _launches() == launches
    assert out.shape == (B, 3)
    np.testing.assert_allclose(out, out_w, atol=TOL_OUT[embed_L], rtol=0)
    # every weight and bias gradient, the head's rows back in ray_embed order
    _assert_grads(grads, g_w, TOL_GRAD[embed_L])
    if need_dx:
        _assert_grads({"dx": dx}, {"dx": dx_w}, TOL_GRAD[embed_L])
    else:
        assert not np.any(dx_w)   # the JAX kernel returns zeros


@pytest.mark.parametrize("grs", [False, True])
def test_function_matches_pallas_interpret_bf16(grs, rng):
    params, tm, x, dout = _setup(rng, grs=grs, embed_L=10, dtype=jnp.bfloat16)
    out_w, g_w, dx_w = _jax_vjp(params, x, dout, grs=grs, res_scale=1.0,
                                embed_L=10, need_dx=True, dtype=jnp.bfloat16)
    out, grads, dx = _port_grads(tm, x, dout, 10, True)
    np.testing.assert_allclose(out, out_w, atol=TOL_BF16_OUT, rtol=0)
    _assert_grads(grads, g_w, TOL_BF16_GRAD)
    _assert_grads({"dx": dx}, {"dx": dx_w}, TOL_BF16_GRAD)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("embed_L", [0, 10])
def test_passes_match_pallas_interpret_bf16(embed_L, need_dx, rng):
    """Pass 1's plain version composed with pass 2's, through the Function,
    against the Pallas backward at bf16 operands, a ragged B of 37."""
    params, tm, x, dout = _setup(rng, grs=True, res_scale=0.5, embed_L=embed_L,
                                 dtype=jnp.bfloat16)
    out_w, g_w, dx_w = _jax_vjp(params, x, dout, grs=True, res_scale=0.5,
                                embed_L=embed_L, need_dx=need_dx, dtype=jnp.bfloat16)
    out, grads, dx = _port_grads(tm, x, dout, embed_L, need_dx)
    np.testing.assert_allclose(out, out_w, atol=TOL_BF16_OUT, rtol=0)
    _assert_grads(grads, g_w, TOL_BF16_GRAD)
    if need_dx:
        _assert_grads({"dx": dx}, {"dx": dx_w}, TOL_BF16_GRAD)


@pytest.mark.parametrize("n_rays", RAGGED_B)
def test_forward_matches_pallas_interpret_ragged(n_rays, rng):
    """The training forward's plain version (what the card's kernel is held
    to) against the Pallas forward at the batches at the tile's edges, f32
    operands."""
    params, tm, _, _ = _setup(rng, grs=True, res_scale=0.5)
    x = (rng.normal(size=(n_rays, K)) * 3.0).astype(np.float32)
    want = np.asarray(jtrain.r2l_train_apply(
        params, jnp.asarray(x), res_scale=0.5, use_global_residual=True, tile_b=16,
        tile_b_bwd=32, dtype=jnp.float32, embed_L=L, need_dx=False, interpret=True))
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), L, torch.float32)
    out, hs = rt.r2l_train_fwd(packed, torch.from_numpy(x), res_scale=0.5,
                               use_global_residual=True)
    assert out.shape == (n_rays, 3) and hs.shape == ((DEPTH - 2) // 2 + 1, n_rays, WIDTH)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL_OUT[L], rtol=0)


@pytest.mark.parametrize("n_sample", sorted({n for _, n in WIDE}))
def test_forward_matches_pallas_interpret_wide_input(n_sample, rng):
    """The training forward's plain version against the Pallas forward at
    inputs whose head the card's kernel runs in parts, f32 operands."""
    params, tm, x, _ = _setup(rng, grs=True, res_scale=0.5, n_sample=n_sample)
    want = np.asarray(jtrain.r2l_train_apply(
        params, jnp.asarray(x), res_scale=0.5, use_global_residual=True, tile_b=16,
        tile_b_bwd=32, dtype=jnp.float32, embed_L=L, need_dx=False, interpret=True))
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), L, torch.float32)
    assert packed["head_w"].shape[1] > 1024
    out, _ = rt.r2l_train_fwd(packed, torch.from_numpy(x), res_scale=0.5,
                              use_global_residual=True)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL_OUT[L], rtol=0)


def _packed_inputs(rng, embed_L=10, grs=False, n_rays=B):
    _, tm, _, _ = _setup(rng, grs=grs, embed_L=embed_L)
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), embed_L, torch.float32)
    cols = K if embed_L else IN_DIM
    x = torch.from_numpy((rng.normal(size=(n_rays, cols)) * 3.0).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32))
    _, hs = rt.r2l_train_fwd_ref(packed, x, use_global_residual=grs)
    return packed, x, hs, dout


@pytest.mark.parametrize("grs", [False, True])
def test_passes_compose_to_the_plain_backward(grs, rng):
    packed, x, hs, dout = _packed_inputs(rng, grs=grs)
    kw = dict(res_scale=0.5, use_global_residual=grs, need_dx=True)
    act = rt.r2l_train_bwd_act(packed, x, hs, dout, **kw)
    nb = (DEPTH - 2) // 2
    # the scratch of pass 2: B = 37 rays padded to one 64-ray tile
    for k in ("dg2", "dg1", "g1"):
        assert act[k].shape == (nb, 64, WIDTH)
    assert act["dpre"].shape == (64, WIDTH) and act["emb"].shape == (64, 256)
    assert act["part"].shape == (1, WIDTH * (1 + 2 * nb + 3) + 3)
    # padded rays carry no cotangent
    for k in ("dg2", "dg1", "dpre"):
        assert not act[k][..., B:, :].any(), k
    want = rt.r2l_train_bwd_ref(packed, x, hs, dout, **kw)
    got = {**rt.r2l_train_wgrad_ref(act, hs), "dx": act["dx"]}
    whole = rt.r2l_train_bwd(packed, x, hs, dout, **kw)
    assert set(got) == set(want) == set(whole)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(whole[k], want[k]), k


def test_ray_chunks_give_the_unchunked_result(rng):
    """A cap of 64 rays splits 150 rays into chunks of 64, 64 and 22 (each
    padded to a tile); their gradients, added in order, equal one pass pair
    over all rays up to the f32 order of the sums."""
    packed, x, hs, dout = _packed_inputs(rng, grs=True, n_rays=150)
    kw = dict(res_scale=0.5, use_global_residual=True, need_dx=True)
    one = rt.r2l_train_bwd(packed, x, hs, dout, **kw)
    chunked = rt.r2l_train_bwd(packed, x, hs, dout, ray_cap=64, **kw)
    for k, w in one.items():
        torch.testing.assert_close(chunked[k], w, rtol=0,
                                   atol=2e-6 * float(w.abs().max()), msg=k)
    with pytest.raises(ValueError, match="multiple of 64"):
        rt.r2l_train_bwd(packed, x, hs, dout, ray_cap=100, **kw)


def test_wgrad_plain_version_is_the_f64_product(rng):
    """r2l_train_wgrad_ref against an f64 numpy product of the same bf16
    operands (and f64 sums of the same per-tile partials)."""
    nb, n_rays, W, in_pad, od = 3, 100, 64, 128, 3
    Bp = 128

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()

    act = {"dg2": bf16(nb, Bp, W), "dg1": bf16(nb, Bp, W), "g1": bf16(nb, Bp, W),
           "dpre": bf16(Bp, W), "emb": bf16(Bp, in_pad),
           "part": torch.from_numpy(rng.normal(
               size=(Bp // 64, W * (1 + 2 * nb + od) + od)).astype(np.float32))}
    hs = bf16(nb + 1, n_rays, W)
    g = rt.r2l_train_wgrad_ref(act, hs)

    def f64(t):
        return t.double().numpy()

    h_in = np.zeros((nb, Bp, W))
    h_in[:, :n_rays] = f64(hs[:nb])
    tol = dict(rtol=1e-5, atol=1e-4)
    for i in range(nb):
        np.testing.assert_allclose(g["body_w"][i, 0], f64(act["dg1"][i]).T @ h_in[i], **tol)
        np.testing.assert_allclose(g["body_w"][i, 1],
                                   f64(act["dg2"][i]).T @ f64(act["g1"][i]), **tol)
    np.testing.assert_allclose(g["head_w"], f64(act["dpre"]).T @ f64(act["emb"]), **tol)
    sums = f64(act["part"]).sum(0)
    flat = np.concatenate([g[k].reshape(-1).numpy() for k in
                           ("head_b", "body_b", "tail_w", "tail_b")])
    np.testing.assert_allclose(flat, sums, **tol)
    # with `grads`, pass 2 adds into them
    twice = rt.r2l_train_wgrad_ref(act, hs, {k: v.clone() for k, v in g.items()})
    for k, v in g.items():
        torch.testing.assert_close(twice[k], 2 * v, rtol=0, atol=0)


@pytest.mark.parametrize("embed_L", [0, 10])
def test_plain_versions_are_the_wrappers_on_cpu(embed_L, rng):
    _, tm, x, dout = _setup(rng, embed_L=embed_L)
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), embed_L,
                                       torch.float32)
    xt, dt = torch.from_numpy(x), torch.from_numpy(dout)
    out, hs = rt.r2l_train_fwd(packed, xt)
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, xt)
    assert torch.equal(out, out_p) and torch.equal(hs, hs_p)
    nb = (DEPTH - 2) // 2
    assert hs.shape == (nb + 1, B, WIDTH)
    g = rt.r2l_train_bwd(packed, xt, hs, dt, need_dx=False)
    assert g["dx"] is None
    assert g["head_w"].shape == (WIDTH, 256) and g["body_w"].shape == (nb, 2, WIDTH, WIDTH)
    # the padding columns of the head carry no gradient
    assert torch.all(g["head_w"][:, IN_DIM:] == 0)


def test_pack_layout(rng):
    params, tm, _, _ = _setup(rng)
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), L)
    assert packed["head_w"].shape == (WIDTH, 256)
    assert packed["head_w"].dtype == torch.bfloat16
    perm = _doubling_head_perm_np(N_SAMPLE, L)
    np.testing.assert_array_equal(
        packed["head_w"][:, :IN_DIM].float().numpy(),
        torch.from_numpy(params["head"]["kernel"][perm].T).bfloat16().float().numpy())
    assert torch.all(packed["head_w"][:, IN_DIM:] == 0)
    # embed_L = 0: the head keeps ray_embed's column order
    plain = rt.pack_r2l_train_weights(rt._model_params(tm), 0, torch.float32)
    np.testing.assert_array_equal(plain["head_w"][:, :IN_DIM].numpy(),
                                  params["head"]["kernel"].T)
    nb = (DEPTH - 2) // 2
    assert packed["body_w"].shape == (nb, 2, WIDTH, WIDTH)
    np.testing.assert_array_equal(
        packed["body_w"][2, 1].float().numpy(),
        torch.from_numpy(params["body"]["lin_1"]["kernel"][2].T).bfloat16().float().numpy())
    # the backward's K-major copy of the [k, n] products' weights
    assert torch.equal(packed["body_wt"], packed["body_w"].transpose(-1, -2))
    assert packed["body_wt"].is_contiguous()
    np.testing.assert_array_equal(packed["body_b"][1, 0].numpy(),
                                  params["body"]["lin_0"]["bias"][1])
    assert packed["tail_w"].shape == (3, WIDTH) and packed["tail_b"].shape == (3,)
    fwd, bwd = rt.r2l_train_flops(packed, 10)
    assert fwd == 2 * 10 * (IN_DIM * WIDTH + 2 * nb * WIDTH ** 2 + WIDTH * 3)
    assert bwd == 2 * 10 * (5 * nb * WIDTH ** 2 + 3 * WIDTH * 3 + IN_DIM * WIDTH)


def test_flagship_bounds_match_the_slice():
    """The operation counts behind the bounds at W256 D88, 98,304 rays."""
    tm = R2LNet(1008, 88, 256)
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), 10)
    fwd, bwd = rt.r2l_train_flops(packed, 1)
    assert (fwd // 2, bwd // 2) == (5_894_912, 14_350_592)
    act, wgrad = rt.r2l_train_pass_flops(packed, 1)
    assert (act // 2, wgrad // 2) == (3 * 43 * 256 ** 2 + 3 * 256 * 3,
                                      2 * 43 * 256 ** 2 + 1008 * 256)


def test_body_gradients_are_views_of_one_buffer(rng):
    _, tm, x, dout = _setup(rng)
    out = rt.r2l_train_apply(tm, torch.from_numpy(x), embed_L=L, need_dx=False)
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(out, params, torch.from_numpy(dout))
    body = [g for n, g in zip(names, grads) if n.startswith("body.")]
    bases = {g._base.data_ptr() for g in body if g._base is not None}
    # weights and biases: two stacked buffers, no copy per parameter
    assert len(body) == 4 * ((DEPTH - 2) // 2) and len(bases) == 2
    assert all(g._base is not None for g in body)


def test_other_profiles_and_inputs_raise(rng):
    tm = R2LNet(IN_DIM, DEPTH, WIDTH, linear_tail=True)
    with pytest.raises(ValueError, match="profile"):
        rt.r2l_train_apply(tm, torch.zeros(4, K), embed_L=L)
    with pytest.raises(ValueError, match="K\\*\\(2L\\+1\\)"):
        rt.pack_r2l_train_weights(rt._model_params(R2LNet(250, DEPTH, WIDTH)), L)
    assert fused_r2l_train_available("cuda")
    assert not fused_r2l_train_available("cpu")


def _random_model(rng, depth, grs=False, dtype=torch.float32, width=256, in_dim=IN_DIM):
    # lecun-normal kernels with each block's second linear times 0.1, small
    # biases: the outputs stay clear of the sigmoid's flat ends (chip_smoke.py)
    tm = R2LNet(in_dim, depth, width, use_residual=grs, dtype=dtype)
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            if ".body.2.weight" in name:
                scale *= 0.1
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    return tm


@pytest.mark.cuda
@pytest.mark.parametrize("embed_L", [0, 10])
@pytest.mark.parametrize("grs", [False, True])
def test_kernels_match_plain_versions(grs, embed_L, cuda_device, rng):
    tm = _random_model(rng, 12, grs).to(cuda_device)
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), embed_L)
    cols = K if embed_L else IN_DIM
    x = torch.from_numpy((rng.normal(size=(B, cols)) * 3.0).astype(np.float32)
                         ).to(cuda_device)
    dout = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)).to(cuda_device)
    launches = _launches()
    out, hs = rt.r2l_train_fwd(packed, x, use_global_residual=grs)
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, use_global_residual=grs)
    g = rt.r2l_train_bwd(packed, x, hs_p, dout, use_global_residual=grs)
    g_p = rt.r2l_train_bwd_ref(packed, x, hs_p, dout, use_global_residual=grs)
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in launches)
    # chip_smoke.py's tolerances, set from the measured summation-order
    # noise (bf16 roundings that flip) at 88 layers
    torch.testing.assert_close(out, out_p, atol=4e-3, rtol=0)
    for name, got, want, tol in [("hs", hs, hs_p, 2e-2)] + [
            (k, g[k], g_p[k], 4e-2 if k == "dx" else 1e-2) for k in g_p]:
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert err <= tol, (name, err.item())


def _forward_check(packed, n_rays, grs, dev, rng, k=K):
    x = torch.from_numpy((rng.normal(size=(n_rays, k)) * 3.0).astype(np.float32)).to(dev)
    launches = rt.r2l_train_fwd.launches
    out, hs = rt.r2l_train_fwd(packed, x, use_global_residual=grs)
    out2, hs2 = rt.r2l_train_fwd(packed, x, use_global_residual=grs)
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, use_global_residual=grs)
    torch.cuda.synchronize()
    assert rt.r2l_train_fwd.launches == launches + 2
    # no atomics, no order that changes
    assert torch.equal(out, out2) and torch.equal(hs, hs2)
    assert hs.shape == hs_p.shape
    torch.testing.assert_close(out, out_p, atol=4e-3, rtol=0)
    assert _rel(hs, hs_p) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", CARD_B)
@pytest.mark.parametrize("grs", [False, True])
def test_forward_kernel_ragged_batches(grs, n_rays, cuda_device, rng):
    """out and every row of hs (stored by TMA, rows past B clipped) at the
    batches at the tile's edges."""
    tm = _random_model(rng, 12, grs).to(cuda_device)
    _forward_check(rt.pack_r2l_train_weights(rt._model_params(tm), 10), n_rays, grs,
                   cuda_device, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 128, 192])
def test_forward_kernel_other_widths(width, cuda_device, rng):
    """With 256, the kernel's four warpgroup widths."""
    tm = _random_model(rng, 6, True, width=width).to(cuda_device)
    _forward_check(rt.pack_r2l_train_weights(rt._model_params(tm), 10), 65, True,
                   cuda_device, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_sample", WIDE)
@pytest.mark.parametrize("embed_L", [0, 10])
def test_forward_kernel_wide_inputs(embed_L, width, n_sample, cuda_device, rng):
    """Inputs of 1280 and 1536 columns, embedded in the kernel (embed_L
    10) or given as rows (embed_L 0), which the kernel contracts in parts
    with the head's sums carried across them."""
    k = 3 * n_sample
    tm = _random_model(rng, 6, True, width=width, in_dim=k * 21).to(cuda_device)
    _forward_check(rt.pack_r2l_train_weights(rt._model_params(tm), embed_L), 192, True,
                   cuda_device, rng, k if embed_L else k * 21)


@pytest.mark.cuda
def test_function_on_the_card_matches_the_cpu(cuda_device, rng):
    """The autograd Function through the kernels against the same Function
    on the CPU (the plain versions), bf16 operands on both."""
    tm = _random_model(rng, DEPTH, dtype=torch.bfloat16)
    tc = _random_model(rng, DEPTH, dtype=torch.bfloat16)
    tc.load_state_dict(tm.state_dict())
    tc = tc.to(cuda_device)
    x = (rng.normal(size=(B, K)) * 3.0).astype(np.float32)
    dout = rng.normal(size=(B, 3)).astype(np.float32)
    out, grads, _ = _port_grads(tm, x, dout, 10, False)
    xc = torch.from_numpy(x).to(cuda_device)
    oc = rt.r2l_train_apply(tc, xc, embed_L=10, need_dx=False)
    oc.backward(torch.from_numpy(dout).to(cuda_device))
    np.testing.assert_allclose(oc.detach().cpu().numpy(), out, atol=4e-3, rtol=0)
    _assert_grads({k: v.grad.cpu().numpy() for k, v in tc.named_parameters()},
                  grads, 1e-2)


def _card_inputs(rng, dev, grs=True, n_rays=300, depth=12, width=256):
    tm = _random_model(rng, depth, grs, width=width).to(dev)
    packed = rt.pack_r2l_train_weights(rt._model_params(tm), 10)
    x = torch.from_numpy((rng.normal(size=(n_rays, K)) * 3.0).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32)).to(dev)
    _, hs = rt.r2l_train_fwd_ref(packed, x, use_global_residual=grs)
    return packed, x, hs, dout


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# pass 1's tile at each width it takes (two warpgroups of W / 2 columns),
# a ragged B, more 64-ray tiles than the card holds blocks at once (141
# tiles; one block a multiprocessor at W256, 132 on an H100), the global
# residual and need_dx each on and off: (width, rays, use_global_residual,
# need_dx)
PASS_CASES = ((256, 300, True, True), (128, 300, True, True), (192, 300, False, True),
              (256, 37, True, False), (256, 9000, False, False))


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_rays,grs,need_dx", PASS_CASES)
def test_each_pass_matches_its_plain_version(width, n_rays, grs, need_dx, cuda_device,
                                             rng):
    packed, x, hs, dout = _card_inputs(rng, cuda_device, grs, n_rays, width=width)
    kw = dict(use_global_residual=grs, need_dx=need_dx)
    launches = rt.r2l_train_bwd_act.launches
    act = rt.r2l_train_bwd_act(packed, x, hs, dout, **kw)
    act_p = rt.r2l_train_bwd_act_ref(packed, x, hs, dout, **kw)
    torch.cuda.synchronize()
    assert rt.r2l_train_bwd_act.launches == launches + 1
    # pass 1, through the gradients pass 2's plain version makes of its
    # scratch: an operand can differ by its whole size where a relu mask
    # flips with the summation order, which the sums over rays average out
    for k in ("dg2", "dg1", "g1", "dpre", "emb", "part"):
        assert act[k].shape == act_p[k].shape, k
    if need_dx:
        assert act["dx"].shape == act_p["dx"].shape
        assert _rel(act["dx"], act_p["dx"]) <= 4e-2
    else:
        assert act["dx"] is None and act_p["dx"] is None
    g_k, g_pk = rt.r2l_train_wgrad_ref(act, hs), rt.r2l_train_wgrad_ref(act_p, hs)
    for k in g_k:
        assert _rel(g_k[k], g_pk[k]) <= 1e-2, k
    # pass 2 on the kernel's own scratch: the same products, summed in another
    # f32 order
    g = rt.r2l_train_wgrad(act, hs)
    g_p = rt.r2l_train_wgrad_ref(act, hs)
    torch.cuda.synchronize()
    for k in g_p:
        assert _rel(g[k], g_p[k]) <= 1e-5, k


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_rays,grs", [(256, 4096, True), (128, 4096, False),
                                              (192, 1000, True), (256, 20000, False)])
def test_backward_is_bit_identical_across_calls(width, n_rays, grs, cuda_device, rng):
    packed, x, hs, dout = _card_inputs(rng, cuda_device, grs, n_rays, width=width)
    a = rt.r2l_train_bwd(packed, x, hs, dout, use_global_residual=grs)
    b = rt.r2l_train_bwd(packed, x, hs, dout, use_global_residual=grs)
    # the weight and bias gradients (dx's embed chain sums in shared memory
    # with atomics)
    for k in rt._OPERANDS:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_ray_chunks_on_the_card(cuda_device, rng):
    packed, x, hs, dout = _card_inputs(rng, cuda_device, n_rays=1000)
    kw = dict(use_global_residual=True, need_dx=True)
    counts = _launches()
    one = rt.r2l_train_bwd(packed, x, hs, dout, **kw)
    chunked = rt.r2l_train_bwd(packed, x, hs, dout, ray_cap=256, **kw)
    torch.cuda.synchronize()
    # one pass pair, then 4 chunks of each pass
    assert _launches()[1:] == (counts[1] + 5, counts[2] + 5)
    for k, w in one.items():
        assert _rel(chunked[k], w) <= 1e-5, k
