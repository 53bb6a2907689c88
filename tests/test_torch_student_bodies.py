"""The student bodies that the driver builds: the port's R2LNet with the
'mlp' body and with `layerwise_widths` against flax R2LNet.apply, the FLOP
counts, and the linearized `ray_points_embed` against the JAX package's; on a
card, the embed and the 'mlp' student's train step against the CPU's.

flax (and the JAX models package, which imports it) is imported inside the
tests that need it: the card's machine has jax but no flax, and its card
tests collect from this file."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.models import R2LNet, flops
from efficient_nerf_tpu_torch.ops import ray_embed as re_

INPUT_DIM, DEPTH, WIDTH, B = 4 * 3 * 21, 6, 32, 17
LAYERWISE = (32, 16, 24, 40, 32)     # head 32, body 16 24 40 32: residual fits
# f32 on both sides: the tolerance of tests/test_torch_r2l.py (sums in
# another order, a few ulps of O(1) activations)
TOL = 1e-5
# bf16 compute on both sides, held as max |got - want| over max |want|:
# torch's bf16 linear adds the bias before its one rounding to bf16, flax
# rounds the product and then the sum, so an activation can land one bf16
# ulp (2^-8 relative) apart and carry through the layers. Measured at most
# 2.2e-2 over 240 random cases of this test's shapes (seeds 0-29); 4e-2 is
# 1.8x that, and a wrong layer, width or key gives errors of order 1.
BF16_TOL = 4e-2
N_SAMPLE, L = 16, 10
NEAR, FAR = 2.0, 6.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _jax_params(model, input_dim, rng):
    """flax init, then numpy noise on every leaf so that biases are nonzero."""
    p = model.init(jax.random.PRNGKey(0), jnp.zeros((1, input_dim)))["params"]
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.05, size=v.shape)
                   ).astype(np.float32), p)


def _pair(rng, dtype=torch.float32, **kw):
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = JaxR2LNet(input_dim=INPUT_DIM, depth=DEPTH, width=WIDTH, dtype=jdtype, **kw)
    params = _jax_params(jm, INPUT_DIM, rng)
    tm = R2LNet(INPUT_DIM, depth=DEPTH, width=WIDTH, dtype=dtype, **kw
                ).load_jax_params(params)
    return jm, params, tm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("linear_tail", [False, True])
@pytest.mark.parametrize("use_residual", [False, True])
@pytest.mark.parametrize("body", ["mlp", "layerwise"])
def test_plain_bodies_match_flax(body, use_residual, linear_tail, dtype, rng):
    kw = dict(use_residual=use_residual, linear_tail=linear_tail)
    kw.update({"body_arch": "mlp"} if body == "mlp" else
              {"layerwise_widths": LAYERWISE})
    jm, params, tm = _pair(rng, dtype, **kw)
    x = rng.normal(size=(B, INPUT_DIM)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (B, 3) and got.dtype == np.float32
    if dtype == torch.bfloat16:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_layerwise_widths_one_short_pad_with_the_output_width(rng):
    # depth - 2 widths: the JAX module's output_dim pad is the last body
    # layer's width, and the tail reads it
    jm, params, tm = _pair(rng, layerwise_widths=LAYERWISE[:DEPTH - 2])
    assert tm.body[2 * (DEPTH - 3)].out_features == 3
    assert tm.tail[0].in_features == 3
    x = rng.normal(size=(B, INPUT_DIM)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params},
                                                        jnp.asarray(x))),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", [{"body_arch": "mlp"},
                                {"layerwise_widths": LAYERWISE}])
def test_plain_body_keys(kw):
    # linears at the even indices of the body's Sequential, the activation
    # (or an Identity) between them
    tm = R2LNet(INPUT_DIM, depth=DEPTH, width=WIDTH, act="none", **kw)
    assert set(tm.state_dict()) == {
        "head.0.weight", "head.0.bias", "tail.0.weight", "tail.0.bias",
        *(f"body.{2 * i}.{p}" for i in range(DEPTH - 2)
          for p in ("weight", "bias"))}
    assert len(tm.body) == 2 * (DEPTH - 2)
    widths = (WIDTH,) * (DEPTH - 1) if "body_arch" in kw else LAYERWISE
    assert [tm.body[2 * i].out_features for i in range(DEPTH - 2)] == list(widths[1:])
    assert tm.head[0].out_features == widths[0]


@pytest.mark.parametrize("kw", [
    dict(depth=8, width=64, input_dim=INPUT_DIM, output_dim=3, n_block=-1,
         n_learnable=2),
    dict(depth=88, width=256, input_dim=1008, output_dim=3, n_block=-1,
         n_learnable=2),
    dict(depth=87, width=256, input_dim=1008, output_dim=4, n_block=10,
         n_learnable=3),
    dict(depth=16, width=128, input_dim=6 * 21, output_dim=3, n_block=-1,
         n_learnable=1)])
def test_r2l_flops_match_jax(kw):
    from efficient_nerf_tpu.models import flops as jflops

    got = flops.r2l_flops_per_pixel(**kw)
    assert got == jflops.r2l_flops_per_pixel(**kw)
    assert isinstance(got, int)


def test_flagship_flops_are_the_papers():
    # Table 2 of the paper: 11.79 MFLOP a pixel for W256 D88 at 1008 inputs;
    # the teacher 303.82 at 64 + 64 + 128 evaluations
    assert round(flops.r2l_flops_per_pixel(1008) / 1e6, 2) == 11.79
    assert round(flops.nerf_flops_per_pixel() / 1e6, 2) == 303.82


@pytest.mark.parametrize("kw", [
    {}, dict(depth=6, width=64, skips=(2,), use_viewdirs=False, n_samples=32,
             n_importance=0),
    dict(input_ch=27, input_ch_views=9, skips=(), n_importance=64)])
def test_nerf_flops_match_jax(kw):
    from efficient_nerf_tpu.models import flops as jflops

    assert flops.nerf_flops_per_pixel(**kw) == jflops.nerf_flops_per_pixel(**kw)
    assert flops.linear_flops(7, 5) == jflops.linear_flops(7, 5) == 70


@pytest.mark.parametrize("n_sample,near,far", [(16, 2.0, 6.0), (4, 0.0, 1.0)])
def test_embed_constants_match_jax(n_sample, near, far):
    from efficient_nerf_tpu.ops.pallas import r2l_forward as jfwd

    want = jfwd._embed_constants_np(n_sample, L, near, far)
    got = re_._embed_constants_np(n_sample, L, near, far)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the elementwise product reads the one entry a column that may be
    # nonzero (P2's columns of a depth 0 are all zero)
    assert ((got[0] != 0).sum(0) == 1).all() and ((got[1] != 0).sum(0) <= 1).all()


def _rays(rng, n=B):
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


# The embed at L = 10 against the JAX function: o @ P1 + d @ P2 is exact on
# both sides (at most one nonzero a column), so y agrees bit for bit; sin
# and cos of |y| up to ~2^9 * 20 differ by the two libraries' ulps (XLA's
# CPU sin is its own polynomial): measured at most 6e-8 over 3,000 rays,
# det and perturbed. A column read from the wrong coordinate or depth gives
# errors of order 1.
EMBED_TOL = 1e-6


def test_ray_points_embed_det_matches_jax(rng):
    from efficient_nerf_tpu.ops import ray_points_embed as jrpe

    o, d = _rays(rng)
    got = re_.ray_points_embed(torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR,
                               N_SAMPLE, L).numpy()
    want = np.asarray(jrpe(jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L))
    assert got.shape == (B, N_SAMPLE * 3 * (2 * L + 1)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    # the identity columns are the points themselves, bit for bit
    ident = np.arange(got.shape[1]) % (2 * L + 1) == 2 * L
    np.testing.assert_array_equal(got[:, ident], want[:, ident])


def test_ray_points_embed_perturbed_matches_jax(rng):
    from efficient_nerf_tpu.ops import ray_points_embed as jrpe

    o, d = _rays(rng)
    key = jax.random.PRNGKey(3)
    # the uniforms JAX's stratify_zvals draws from `key`
    t = np.array(jax.random.uniform(key, (B, N_SAMPLE)))
    got = re_.ray_points_embed(torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR,
                               N_SAMPLE, L, perturb=True,
                               t_rand=torch.from_numpy(t)).numpy()
    want = np.asarray(jrpe(jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L,
                           key=key, perturb=True))
    # the same jittered depths on both sides (one ulp apart would move a
    # 2^9-scaled phase by ~2^9 ulps; measured equal)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    det = re_.ray_points_embed(torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR,
                               N_SAMPLE, L).numpy()
    assert np.abs(got - det).max() > 0.1    # the jitter moved the points


def test_ray_points_embed_draws_from_the_generator(rng):
    o, d = (torch.from_numpy(x) for x in _rays(rng))
    a, b = (re_.ray_points_embed(o, d, NEAR, FAR, N_SAMPLE, L, perturb=True,
                                 generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_ray_points_embed_on_the_card_matches_the_cpu(cuda_device, rng):
    # no TF32 anywhere: a TF32 product would move the 2^9-scaled phases by
    # O(1); the card's sin/cos differ from the CPU's by their ulps
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        o, d = _rays(rng, 4096)
        o, d = torch.from_numpy(o * 3), torch.from_numpy(d)
        want = re_.ray_points_embed(o, d, NEAR, FAR, N_SAMPLE, L)
        got = re_.ray_points_embed(o.to(cuda_device), d.to(cuda_device), NEAR, FAR,
                                   N_SAMPLE, L).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ident = np.arange(want.shape[1]) % (2 * L + 1) == 2 * L
    assert torch.equal(got[:, ident], want[:, ident])
    assert (got - want).abs().max().item() <= EMBED_TOL


@pytest.mark.cuda
def test_mlp_train_step_on_the_card_matches_the_cpu(cuda_device, rng):
    """One step of the 'mlp' student (depth 8, width 64, f32, TF32 off) on
    the card against the CPU, the same weights and draws, exact embeds (the
    fast embed's 2^9 amplification of a trig ulp flips relu masks: the full
    depth is held in norm by chip_smoke.py's train_mlp): the loss to 1e-5
    relative, each gradient to 5e-3 of its largest entry, and the weights
    after Adam to a tenth of lr where the gradients agree to a tenth."""
    from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                                make_r2l_train_step)

    depth, width, n_sample, n, hard = 8, 64, 4, 256, (32, 32)
    in_dim = 3 * n_sample * (2 * L + 1)
    ref = R2LNet(in_dim, depth, width, body_arch="mlp", use_residual=True)
    o, d = _rays(rng, n)
    t = rng.uniform(size=(n, 3)).astype(np.float32)
    noise = {"t_rand": torch.from_numpy(
                 rng.uniform(size=(n + hard[1], n_sample)).astype(np.float32)),
             "idx_out": torch.from_numpy(rng.permutation(64)[:hard[1]]),
             "batch_idx": torch.from_numpy(rng.integers(0, n, hard[1]))}
    out = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in (cuda_device, torch.device("cpu")):
            m = R2LNet(in_dim, depth, width, body_arch="mlp", use_residual=True)
            m.load_state_dict(ref.state_dict())
            m.to(dev)
            opt = torch.optim.Adam(m.parameters(), lr=1e-3)
            step = make_r2l_train_step(m, opt, near=NEAR, far=FAR, n_sample=n_sample,
                                       L=L, hard=hard, fast_embed=False,
                                       device=dev)
            _, _, met = step(init_train_state(m, opt), hard_pool_init(64, device=dev),
                             None, *(torch.from_numpy(x).to(dev) for x in (o, d, t)),
                             noise={k: v.to(dev) for k, v in noise.items()})
            out.append((met["loss_rgb"].item(),
                        {k: (p.detach().cpu(), p.grad.cpu())
                         for k, p in m.named_parameters()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (loss_a, pa), (loss_b, pb) = out
    assert abs(loss_a - loss_b) <= 1e-5 * abs(loss_b)
    for k, (w_b, g_b) in pb.items():
        w_a, g_a = pa[k]
        dg = (g_a - g_b).abs()
        assert dg.max() <= 5e-3 * g_b.abs().max(), k
        sure = dg <= g_b.abs() / 10
        assert (w_a - w_b).abs()[sure].max() <= 0.1 * 1e-3, k
