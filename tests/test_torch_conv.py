"""The conv student of the patch modes against the JAX package: R2LConvNet
against flax (conv and resblock bodies, BatchNorm off and on, eval and train
mode, the running statistics after a train-mode call), sample_patch_points
with injected draws, three make_patch_train_step steps against the JAX step
fed its own draws, and the renderer's frame and ray paths for the conv
student."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core import ray_sampler as jrs
from efficient_nerf_tpu.models import R2LConvNet as JaxConvNet
from efficient_nerf_tpu_torch.core.ray_sampler import sample_patch_points
from efficient_nerf_tpu_torch.models import R2LConvNet
from efficient_nerf_tpu_torch.render import r2l_forward_rays, r2l_render_image
from efficient_nerf_tpu_torch.train import init_train_state, make_patch_train_step

N_SAMPLE, L = 4, 3
IN_DIM = 3 * N_SAMPLE * (2 * L + 1)
NEAR, FAR = 2.0, 6.0
# f32 on both sides: the convolutions sum in another order (XLA's and
# oneDNN's), measured at most 1.2e-7 on the outputs and 6e-8 on the running
# statistics
TOL = 1e-5
LR = 1e-3
# parameters after Adam, in units of lr: its first steps map each gradient
# to about +-lr whatever its size, so a gradient near the two packages'
# disagreement moves its update by a part of one lr (a sign error is 2 lr)
PARAM_TOL_LR = 0.05
# ... except the bias of a conv that a BatchNorm follows: the norm subtracts
# the batch's mean, so its gradient is 0 but for rounding on both sides, and
# Adam maps that noise to up to +-lr a step (measured 0.47 lr after one)
CASES = [(arch, bn) for arch in ("conv", "resblock") for bn in (False, True)]


def _models(arch, bn, k=3, seed=1):
    jm = JaxConvNet(input_dim=IN_DIM, depth=6, width=16, kernel_size=k, body_arch=arch,
                    use_bn=bn, res_scale=0.5)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, IN_DIM)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))
    tm = R2LConvNet(IN_DIM, 6, 16, kernel_size=k, body_arch=arch, use_bn=bn, res_scale=0.5)
    tm.load_jax_params(params, stats or None)
    return jm, v, tm


def _stats_err(tm, stats):
    sd = tm.state_dict()
    return max(np.abs(sd[f"{n}.running_{k}"].numpy() - np.asarray(s[m])).max()
               for n, s in stats.items() for k, m in (("mean", "mean"), ("var", "var")))


@pytest.mark.parametrize("arch,bn", CASES)
@pytest.mark.parametrize("k", [1, 3])
def test_conv_student_matches_flax(arch, bn, k, rng):
    jm, v, tm = _models(arch, bn, k)
    x = rng.normal(size=(3, 5, 4, IN_DIM)).astype(np.float32)
    tm.eval()
    got = tm(torch.from_numpy(x))
    assert got.shape == (3, 5, 4, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=TOL, rtol=0)
    if bn:
        # train mode: the batch's statistics, and the running ones updated
        want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tm.train()
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
        assert _stats_err(tm, upd["batch_stats"]) <= TOL
        assert int(tm.head_bn.num_batches_tracked) == 1


def test_conv_student_bf16_and_bad_arch():
    _, _, tm = _models("resblock", True)
    tm.dtype = torch.bfloat16
    tm.eval()
    out = tm(torch.zeros((1, 4, 4, IN_DIM)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="body_arch"):
        R2LConvNet(IN_DIM, body_arch="mlp")


@pytest.mark.parametrize("shape", [(5, 3, 3), (4, 1, 2), (2, 16, 16)])
def test_sample_patch_points_matches_jax(shape, rng):
    o = rng.normal(size=shape + (3,)).astype(np.float32)
    d = rng.normal(size=shape + (3,)).astype(np.float32)
    t = rng.uniform(size=shape[:1]).astype(np.float32)
    for perturb in (False, True):
        got = sample_patch_points(torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR,
                                  N_SAMPLE, perturb=perturb, t_rand=torch.from_numpy(t))
        want = jrs.sample_patch_points(jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE,
                                       perturb=perturb, t_rand=jnp.asarray(t))
        assert got.shape == shape + (3 * N_SAMPLE,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one jitter a patch: the depths of every pixel of a patch move together
    g = torch.Generator().manual_seed(0)
    pts = sample_patch_points(torch.zeros(shape + (3,)), torch.ones(shape + (3,)), NEAR,
                              FAR, N_SAMPLE, perturb=True, generator=g)
    assert torch.equal(pts, pts[:, :1, :1].expand_as(pts))


@pytest.mark.parametrize("arch,bn", CASES)
def test_three_patch_steps_match_jax(arch, bn, rng):
    import optax

    from efficient_nerf_tpu.train import steps as jsteps

    jm, v, tm = _models(arch, bn)
    jopt = optax.adam(LR, b1=0.9, b2=0.999)
    jstep = jsteps.make_patch_train_step(jm, jopt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                                         L=L, use_bn=bn, fast_embed=False, jit=False)
    jstate = jsteps.init_train_state(v["params"], jopt)
    stats = v.get("batch_stats", {})
    opt = torch.optim.Adam(tm.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_patch_train_step(tm, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE, L=L,
                                 fast_embed=False, device="cpu")
    state = init_train_state(tm, opt)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 3)):
        o = (rng.normal(size=(4, 3, 3, 3)) * 0.1).astype(np.float32)
        d = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
        t = rng.uniform(size=(4, 3, 3, 3)).astype(np.float32)
        jstate, stats, jmet = jstep(jstate, stats, key, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t))
        t_rand = torch.from_numpy(np.array(jax.random.uniform(key, (4,))))
        state, met = step(state, None, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(t), t_rand=t_rand)
        assert state.step == i + 1
        np.testing.assert_allclose(float(met["loss_rgb"]), float(jmet["loss_rgb"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["psnr"]), float(jmet["psnr"]), rtol=1e-5)
        sd = tm.state_dict()
        for name, leaves in jax.tree_util.tree_map(np.asarray, jstate.params).items():
            for leaf, value in leaves.items():
                key_t = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
                mine = sd[f"{name}.{key_t}"].numpy()
                want = value.transpose(3, 2, 0, 1) if leaf == "kernel" else value
                moved = np.abs(mine - want).max() / LR
                if bn and leaf == "bias" and name != "tail" and "bn" not in name:
                    grad = getattr(tm, name).bias.grad.abs().max()
                    assert grad <= 1e-6 * float(met["loss_rgb"]), (name, i, grad)
                    assert moved <= 2.0 * (i + 1), (name, leaf, i, moved)
                else:
                    assert moved <= PARAM_TOL_LR, (name, leaf, i, moved)
        if bn and i == 0:
            # after one step; later, the noise-level conv biases above (which
            # shift a batch's mean) differ between the packages
            assert _stats_err(tm, stats) <= TOL


def test_renderer_serves_the_conv_student(rng):
    from efficient_nerf_tpu.render import r2l_renderer as jr

    jm, v, tm = _models("resblock", True)
    tm.train()     # the renderer evaluates in eval mode and restores the mode
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.1, -0.2, 4.0]
    got = r2l_render_image(tm, c2w, 6, 5, 7.0, NEAR, FAR, N_SAMPLE, L, device="cpu")
    want = jr.r2l_render_image(jm, v["params"], jnp.asarray(c2w), 6, 5, 7.0, NEAR, FAR,
                               N_SAMPLE, L, batch_stats=v["batch_stats"])
    assert got.shape == (6, 5, 3) and tm.training
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    o = rng.normal(size=(7, 3)).astype(np.float32)
    d = rng.normal(size=(7, 3)).astype(np.float32)
    got = r2l_forward_rays(tm, o, d, NEAR, FAR, N_SAMPLE, L, device="cpu")
    want = jr.r2l_forward_rays(jm, v["params"], jnp.asarray(o), jnp.asarray(d), NEAR, FAR,
                               N_SAMPLE, L, batch_stats=v["batch_stats"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="int8"):
        r2l_render_image(tm, c2w, 6, 5, 7.0, NEAR, FAR, N_SAMPLE, L, quant="int8",
                         device="cpu")
