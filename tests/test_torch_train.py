"""The port's student training (perturbed sampling, the hard-ray pool, the
learning-rate schedule and the train step) against the JAX package's, with
the same numpy inputs and the JAX step's own random draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core import ray_sampler as jrs
from efficient_nerf_tpu.core import sampling as jsamp
from efficient_nerf_tpu.train import hard_mining as jhard
from efficient_nerf_tpu.train import schedules as jsched
from efficient_nerf_tpu_torch.core import ray_sampler, sampling
from efficient_nerf_tpu_torch.models import R2LNet
from efficient_nerf_tpu_torch.models.weights import r2l_state_dict_from_params
from efficient_nerf_tpu_torch.ops import r2l_train as rt
from efficient_nerf_tpu_torch.ops.r2l_forward import r2l_forward_fused
from efficient_nerf_tpu_torch.render.r2l_renderer import _packed
from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                            make_lr_schedule, make_r2l_train_step,
                                            mse_to_psnr, parse_warmup,
                                            pick_hard_rays, update_hard_pool)

N_SAMPLE, L, DEPTH, WIDTH, B = 4, 10, 8, 32, 37
IN_DIM = 3 * N_SAMPLE * (2 * L + 1)
NEAR, FAR = 2.0, 6.0
HARD = (8, 8)           # (n_hard_in, n_hard_out)
POOL = 16               # full after two steps; the third replaces rows
LR, DECAY, WARMUP = 5e-4, 500, (1e-4, 2)


def _ulps(a, b):
    """|a - b| in units of the f32 spacing at b."""
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def test_stratify_zvals_matches_jax(rng):
    z = np.broadcast_to(np.asarray(jsamp.linear_zvals(NEAR, FAR, 16)), (B, 16))
    t = rng.uniform(size=(B, 16)).astype(np.float32)
    got = sampling.stratify_zvals(torch.from_numpy(z.copy()),
                                  torch.from_numpy(t)).numpy()
    want = np.asarray(jsamp.stratify_zvals(None, jnp.asarray(z), jnp.asarray(t)))
    # the same f32 operations in the same order: within one ulp
    assert _ulps(got, want).max() <= 1.0


def test_stratify_zvals_draws_from_the_generator():
    z = sampling.linear_zvals(NEAR, FAR, 8, device="cpu").expand(5, 8)
    a = sampling.stratify_zvals(z, generator=torch.Generator().manual_seed(3))
    b = sampling.stratify_zvals(z, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    mids = torch.cat([z[:, :1], 0.5 * (z[:, 1:] + z[:, :-1]), z[:, -1:]], 1)
    assert torch.all(a >= mids[:, :-1]) and torch.all(a <= mids[:, 1:])


@pytest.mark.parametrize("n_sample", [4, 16])
def test_perturbed_sample_ray_points_matches_jax(n_sample, rng):
    o = rng.normal(size=(B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    t = rng.uniform(size=(B, n_sample)).astype(np.float32)
    got = ray_sampler.sample_ray_points(
        torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR, n_sample,
        perturb=True, t_rand=torch.from_numpy(t)).numpy()
    want = np.asarray(jrs.sample_ray_points(
        jnp.asarray(o), jnp.asarray(d), NEAR, FAR, n_sample, perturb=True,
        t_rand=jnp.asarray(t)))
    assert got.shape == (B, 3 * n_sample)
    # o + d z on jittered depths: one ulp of a depth up to 6 times |d|
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_hard_pool_matches_jax_while_filling_and_full(rng):
    n_in, n_out, P, D = 6, 6, 15, 9
    pool = hard_pool_init(P, D, device="cpu")
    jpool = jhard.hard_pool_init(P, D)
    for it in range(5):   # fills in three steps (clamped at the end), then full
        batch = rng.normal(size=(B, D)).astype(np.float32)
        # distinct pool indices: XLA's scatter and index_put_ do not promise
        # which of two writes to one row wins
        idx_out = rng.permutation(P)[:n_out].astype(np.int32)
        batch_idx = rng.integers(0, B, n_out).astype(np.int32)
        picked, idx = pick_hard_rays(pool, None, torch.from_numpy(batch), n_out,
                                     idx_out=torch.from_numpy(idx_out).long(),
                                     batch_idx=torch.from_numpy(batch_idx).long())
        full = bool(jpool.count >= P)
        want = np.asarray(jpool.rays)[idx_out] if full else batch[batch_idx]
        np.testing.assert_array_equal(picked.numpy(), want)
        aug = np.concatenate([batch, picked.numpy()])
        mse = rng.uniform(size=(len(aug),)).astype(np.float32)
        pool = update_hard_pool(pool, torch.from_numpy(aug), torch.from_numpy(mse),
                                idx, n_in, B)
        jpool = jhard.update_hard_pool(jpool, jnp.asarray(aug), jnp.asarray(mse),
                                       jnp.asarray(idx_out), n_in, B, exact=True)
        assert pool.count == int(jpool.count) == min((it + 1) * n_in, P)
        np.testing.assert_array_equal(pool.rays.numpy(), np.asarray(jpool.rays))


def test_pick_hard_rays_draws_from_the_generator():
    pool = hard_pool_init(10, device="cpu")
    batch = torch.arange(90, dtype=torch.float32).reshape(10, 9)
    a, ia = pick_hard_rays(pool, torch.Generator().manual_seed(1), batch, 4)
    b, ib = pick_hard_rays(pool, torch.Generator().manual_seed(1), batch, 4)
    assert torch.equal(a, b) and torch.equal(ia, ib) and a.shape == (4, 9)
    assert torch.all((ia >= 0) & (ia < 10))


@pytest.mark.parametrize("warmup", [None, (1e-4, 200)])
def test_lr_schedule_matches_jax(warmup):
    got = make_lr_schedule(LR, DECAY, warmup)
    want = jsched.make_lr_schedule(LR, DECAY, warmup)
    # around the warmup's end, and far into the decay
    for step in (0, 1, 2, 100, 199, 200, 201, 5000, 250_000, 500_000):
        g = got(step)
        assert isinstance(g, float)
        # both in f32; the power may round one ulp apart
        np.testing.assert_allclose(g, float(want(step)), rtol=2e-7, atol=0)
    assert parse_warmup("0.0001,200") == jsched.parse_warmup("0.0001,200") == (1e-4, 200)
    assert parse_warmup("") is None


def test_mse_to_psnr_matches_jax():
    from efficient_nerf_tpu.train.steps import mse_to_psnr as jpsnr

    m = np.float32([0.5, 1e-3, 0.0123])
    np.testing.assert_allclose(mse_to_psnr(torch.from_numpy(m)).numpy(),
                               np.asarray(jpsnr(jnp.asarray(m))), rtol=1e-6)


def _models(rng, learn_depth):
    # flax is imported here, not at the top, like every JAX model use in the
    # port's tests
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    out_dim = 4 if learn_depth else 3
    jm = JaxR2LNet(input_dim=IN_DIM, depth=DEPTH, width=WIDTH, output_dim=out_dim,
                   use_residual=True, dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IN_DIM)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)
                   ).astype(np.float32), p)
    tm = R2LNet(IN_DIM, DEPTH, WIDTH, output_dim=out_dim, use_residual=True
                ).load_jax_params(params)
    return jm, params, tm


def _jax_draws(key, P, n_out, B_aug):
    """The random numbers the JAX step draws from `key` (steps.py:128,
    hard_mining.py:49-51, the uniform of stratify_zvals)."""
    k_pick, k_perturb = jax.random.split(key)
    k_pool, k_batch = jax.random.split(k_pick)
    idx_out = jax.random.randint(k_pool, (n_out,), 0, P)
    batch_idx = jax.random.randint(k_batch, (n_out,), 0, B)
    t_rand = jax.random.uniform(k_perturb, (B_aug, N_SAMPLE))
    return {"idx_out": torch.tensor(np.asarray(idx_out), dtype=torch.long),
            "batch_idx": torch.tensor(np.asarray(batch_idx), dtype=torch.long),
            "t_rand": torch.tensor(np.asarray(t_rand))}


def _step_keys(n_steps, full_from):
    """Keys of n_steps JAX steps whose draws give distinct pool indices on
    the steps that write into a full pool (see the hard pool test)."""
    for seed in range(100):
        keys = list(jax.random.split(jax.random.PRNGKey(seed), n_steps))
        if all(len(set(_jax_draws(k, POOL, HARD[1], B + HARD[1])["idx_out"]
                       .tolist())) == HARD[1] for k in keys[full_from:]):
            return keys
    raise AssertionError("no seed gives distinct pool indices")


# Three Adam steps, f32 models on both sides. The losses agree as the
# forwards do (1e-5 relative; the fused embed's fast trig, 2e-4 of an rgb,
# moves an MSE of ~0.1 by ~1e-5). Parameters: Adam's first steps map each
# gradient to about +-lr whatever its size, so their difference is stated in
# units of lr: a gradient whose size is near the two packages' disagreement
# (1e-5 to 5e-4 of the largest, tests/test_torch_r2l_train.py) moves its
# normalised update m/sqrt(v) by a part of one lr. Measured at most 0.0046
# lr over the three cases; a sign flip would be 2 lr.
LOSS_RTOL = 5e-5
PARAM_TOL_LR = 0.02


@pytest.mark.parametrize("fused,learn_depth", [(False, False), (True, False),
                                               (True, True)])
def test_three_train_steps_match_jax(fused, learn_depth, rng):
    import optax

    from efficient_nerf_tpu.train import steps as jsteps

    jm, params, tm = _models(rng, learn_depth)
    jsched_fn = jsched.make_lr_schedule(LR, DECAY, WARMUP)
    jstep = jsteps.make_r2l_train_step(
        jm, optax.adam(jsched_fn, b1=0.9, b2=0.999), near=NEAR, far=FAR,
        n_sample=N_SAMPLE, L=L, perturb=True, learn_depth=learn_depth,
        hard=HARD, exact_hard_mining=True, fused=fused, interpret=True,
        jit=False)
    jstate = jsteps.init_train_state(params, optax.adam(jsched_fn, b1=0.9, b2=0.999))
    jpool = jhard.hard_pool_init(POOL, 6 + (4 if learn_depth else 3))

    opt = torch.optim.Adam(tm.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_r2l_train_step(tm, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                               L=L, perturb=True, learn_depth=learn_depth,
                               hard=HARD, fused=fused,
                               schedule=make_lr_schedule(LR, DECAY, WARMUP),
                               device="cpu")
    state = init_train_state(tm, opt)
    pool = hard_pool_init(POOL, 6 + (4 if learn_depth else 3), device="cpu")
    assert state.step == 0 and pool.count == 0

    launches = (rt.r2l_train_fwd.launches, rt.r2l_train_bwd_act.launches,
                rt.r2l_train_wgrad.launches)
    for i, key in enumerate(_step_keys(3, full_from=2)):
        o = rng.normal(size=(B, 3)).astype(np.float32)
        d = rng.normal(size=(B, 3)).astype(np.float32)
        t = rng.uniform(size=(B, 4 if learn_depth else 3)).astype(np.float32)
        jstate, jpool, jmet = jstep(jstate, jpool, key, jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(t))
        state, pool, met = step(state, pool, None, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(t),
                                noise=_jax_draws(key, POOL, HARD[1], B + HARD[1]))
        assert state.step == i + 1 and pool.count == int(jpool.count)
        for k in ("loss_rgb", "loss_depth", "psnr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        # the pool holds the same rays (their ranking by MSE agrees)
        np.testing.assert_allclose(pool.rays.numpy(), np.asarray(jpool.rays),
                                   atol=1e-6, rtol=0)
        want = r2l_state_dict_from_params(
            jax.tree_util.tree_map(np.asarray, jstate.params))
        lr_max = max(jsched_fn(s) for s in range(i + 1))
        for k, v in tm.state_dict().items():
            diff = np.abs(v.numpy() - want[k]).max()
            assert diff <= PARAM_TOL_LR * float(lr_max), (k, i, diff / lr_max)
    # on the CPU the fused mode runs the kernels' plain versions
    assert (rt.r2l_train_fwd.launches, rt.r2l_train_bwd_act.launches,
            rt.r2l_train_wgrad.launches) == launches


def test_train_step_gates(rng):
    _, _, tm = _models(rng, False)
    opt = torch.optim.Adam(tm.parameters())
    bad = R2LNet(IN_DIM, DEPTH, WIDTH, linear_tail=True)
    with pytest.raises(ValueError, match="profile"):
        make_r2l_train_step(bad, torch.optim.Adam(bad.parameters()), near=NEAR,
                            far=FAR, n_sample=N_SAMPLE, fused=True, device="cpu")
    with pytest.raises(ValueError, match="model.to"):
        make_r2l_train_step(tm, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                            device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_r2l_train_step(tm, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE)


def test_auto_mode_takes_the_unfused_path_on_the_cpu(rng, monkeypatch):
    from efficient_nerf_tpu_torch.train import steps

    _, _, tm = _models(rng, False)
    calls = []
    monkeypatch.setattr(steps, "r2l_train_apply",
                        lambda *a, **k: calls.append(1) or rt.r2l_train_apply(*a, **k))
    for fused, want in ((None, 0), (True, 1)):
        opt = torch.optim.Adam(tm.parameters())
        step = make_r2l_train_step(tm, opt, near=NEAR, far=FAR,
                                   n_sample=N_SAMPLE, fused=fused, device="cpu")
        o = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
        state, _, met = step(init_train_state(tm, opt), None,
                             torch.Generator().manual_seed(0), o, o,
                             torch.rand(B, 3))
        assert len(calls) == want and np.isfinite(float(met["loss_rgb"]))


def test_auto_mode_on_the_card_refuses_a_model_the_kernels_cannot_take(rng, monkeypatch):
    # an eligible f32 model on the card raises rather than quietly taking
    # the unfused path; fused=False asks for that path
    from efficient_nerf_tpu_torch.train import steps

    monkeypatch.setattr(steps, "fused_r2l_train_available", lambda dev: True)
    _, _, tm = _models(rng, False)
    opt = torch.optim.Adam(tm.parameters())
    kw = dict(near=NEAR, far=FAR, n_sample=N_SAMPLE, device="cpu")
    for fused in (None, True):
        with pytest.raises(ValueError, match="bf16"):
            make_r2l_train_step(tm, opt, fused=fused, **kw)
    make_r2l_train_step(tm, opt, fused=False, **kw)
    bm = R2LNet(IN_DIM, DEPTH, WIDTH, dtype=torch.bfloat16)
    make_r2l_train_step(bm, torch.optim.Adam(bm.parameters()), **kw)


def test_serving_sees_a_fused_adam_step_taken_outside_the_train_step(rng):
    # fused Adam writes the parameters without bumping their version
    # counters; the serving pack's key counts optimizer steps as well
    _, _, tm = _models(rng, False)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, fused=True)
    before = _packed(tm, N_SAMPLE, L)
    versions = [p._version for p in tm.parameters()]
    for p in tm.parameters():
        p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
    opt.step()
    assert [p._version for p in tm.parameters()] == versions   # no bump
    after = _packed(tm, N_SAMPLE, L)
    assert after is not before
    assert not torch.equal(after["body_w"], before["body_w"])
    assert _packed(tm, N_SAMPLE, L) is after        # cached again


@pytest.mark.parametrize("fused_adam", [False, True])
def test_a_step_moves_the_weights_that_serving_uses(fused_adam, rng):
    _, _, tm = _models(rng, False)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, fused=fused_adam)
    step = make_r2l_train_step(tm, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                               L=L, device="cpu")
    o = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    before = _packed(tm, N_SAMPLE, L)
    assert _packed(tm, N_SAMPLE, L) is before       # cached while unchanged
    rgb0 = r2l_forward_fused(before, o, d, NEAR, FAR, N_SAMPLE, L,
                             use_global_residual=True)
    step(init_train_state(tm, opt), None, torch.Generator().manual_seed(0), o, d,
         torch.rand(B, 3))
    after = _packed(tm, N_SAMPLE, L)                # the in-place update shows
    assert after is not before
    assert not torch.equal(after["body_w"], before["body_w"])
    rgb1 = r2l_forward_fused(after, o, d, NEAR, FAR, N_SAMPLE, L,
                             use_global_residual=True)
    assert not torch.equal(rgb0, rgb1)
