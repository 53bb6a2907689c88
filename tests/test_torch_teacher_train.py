"""The port's NeRF teacher training step against the JAX package's, from the
same weights, with the JAX step's own random draws fed through the port's
hooks: the loss, every gradient, and the weights after one and three Adam
steps, with NDC and viewdirs off and on, and one network for both passes.
Also the counterparts of the JAX package's own step tests, and the gates:
NDC without hwf, and the kernel paths (which have no backward) under
autograd."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.core.rays import get_rays_np, ndc_rays
from efficient_nerf_tpu_torch.models import NeRFMLP
from efficient_nerf_tpu_torch.models.weights import nerf_state_dict_from_params
from efficient_nerf_tpu_torch.render import RenderConfig, render_rays
from efficient_nerf_tpu_torch.train import init_train_state, make_teacher_train_step

DEPTH, WIDTH, N_SAMPLES, N_IMPORTANCE, B = 3, 32, 8, 4, 48
LR = 5e-4
H, W, FOCAL = 10, 12, 14.0
# With exact embeds (fast_embed=False). The loss: f32 fields that differ by
# summation order, composited alike: measured 1e-7 relative. Gradients, as
# max |port - JAX| over max |JAX| of each tensor: the same, carried back
# through the layers and both passes: measured at most 4e-5. Parameters
# after Adam, in units of lr: Adam's first steps map each gradient to about
# +-lr whatever its size, so a gradient component near the two packages'
# disagreement moves its update by a part of one lr (measured at most 0.028
# lr); a sign error would be 2 lr.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
PARAM_TOL_LR = 0.05
# With the fast embed (the training default): the two packages' double-angle
# recurrences start from XLA's and torch's sin/cos of the base angle and
# double it 9 times, so a coarse weight moves by ~1e-5, and through the
# inverse CDF a fine depth in a low-weight interval by up to ~1e-3, which the
# embed's 2^9 frequency turns into a few per cent of a fine gradient's
# largest entry (measured 4.6%). The loss and the coarse network keep the
# tolerances above (its gradients do not see the fine depths); the fine
# network's gradients are held by ||port - JAX|| / ||JAX|| (measured at most
# 9.5e-3) and its weights to half an lr (measured 0.28 lr).
FAST_FINE_GRAD_NORM = 3e-2
FAST_FINE_PARAM_TOL_LR = 0.5


def _cfg(cls, ndc, viewdirs, **kw):
    base = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=True,
                white_bkgd=not ndc, use_viewdirs=viewdirs, ndc=ndc,
                near=0.0 if ndc else 2.0, far=1.0 if ndc else 6.0)
    base.update(kw)
    return cls(**base)


def _params(rng, viewdirs, shared):
    """A JAX NeRFMLP and its coarse/fine param trees, perturbed from the
    flax init so that coarse and fine differ."""
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    kw = {} if viewdirs else dict(input_ch_views=0, use_viewdirs=False)
    jm = JaxNeRFMLP(depth=DEPTH, width=WIDTH, **kw)
    p = jm.init(jax.random.PRNGKey(0),
                jnp.zeros((1, jm.input_ch + jm.input_ch_views)))["params"]

    def perturbed():
        return jax.tree_util.tree_map(
            lambda v: (np.asarray(v) + rng.normal(scale=0.05, size=v.shape)
                       ).astype(np.float32), p)

    params = {"coarse": perturbed()}
    if not shared:
        params["fine"] = perturbed()
    return jm, params, kw


def _torch_model(params, kw):
    return NeRFMLP(depth=DEPTH, width=WIDTH, **kw).load_jax_params(params)


def _rays(rng, ndc):
    if ndc:
        c2w = np.concatenate([np.eye(3, dtype=np.float32),
                              np.array([[0.1], [0.2], [0.3]], np.float32)], 1)
        o, d = get_rays_np(H, W, FOCAL, c2w)
        pick = rng.permutation(H * W)[:B]
        o, d = o.reshape(-1, 3)[pick], d.reshape(-1, 3)[pick]
    else:
        o = rng.normal(size=(B, 3)).astype(np.float32) * 0.3
        o[:, 2] += 4.0
        d = (rng.normal(size=(B, 3)) * 0.3 + [0, 0, -1]).astype(np.float32)
    t = rng.uniform(size=(B, 3)).astype(np.float32)
    return np.ascontiguousarray(o, np.float32), np.ascontiguousarray(d, np.float32), t


def _jax_draws(key):
    """The random numbers the JAX step draws from `key`: render_rays splits
    it four ways (renderer.py:266-267); t_rand as stratify_zvals draws it,
    u through sorted_uniform (the coarse and fine sigma noise is off)."""
    from efficient_nerf_tpu.core import sampling as jsamp

    k_strat, k_pdf, _, _ = jax.random.split(key, 4)
    t_rand = jax.random.uniform(k_strat, (B, N_SAMPLES))
    u = jsamp.sorted_uniform(k_pdf, (B, N_IMPORTANCE))
    return {"t_rand": torch.tensor(np.asarray(t_rand)), "u": torch.tensor(np.asarray(u))}


def _jax_loss(jm, jcfg, key, o, d, t, hwf):
    """The JAX step's loss as a function of its params (steps.py:275-295),
    for its gradients."""
    from efficient_nerf_tpu.core.rays import ndc_rays as jndc
    from efficient_nerf_tpu.render.renderer import render_rays as jrender

    def loss(params):
        vd = None
        if jcfg.use_viewdirs:
            vd = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        ro, rd = (jndc(*hwf, 1.0, o, d) if jcfg.ndc else (o, d))
        res = jrender(jm, params["coarse"], params.get("fine"), ro, rd, vd, key, jcfg)
        return jnp.mean((res.rgb - t) ** 2) + jnp.mean((res.rgb0 - t) ** 2)

    return loss


def _state_dict_np(params, viewdirs):
    return nerf_state_dict_from_params(jax.tree_util.tree_map(np.asarray, params),
                                       DEPTH, viewdirs)


@pytest.mark.parametrize("ndc,viewdirs,shared,fast", [
    (False, True, False, False), (True, True, False, False), (False, False, False, False),
    (True, False, False, False), (False, True, True, False), (False, True, False, True),
    (False, False, False, True)])
def test_three_teacher_steps_match_jax(ndc, viewdirs, shared, fast, rng):
    import optax

    from efficient_nerf_tpu.render import RenderConfig as JaxRenderConfig
    from efficient_nerf_tpu.train import steps as jsteps

    jm, params, kw = _params(rng, viewdirs, shared)
    jcfg, tcfg = (_cfg(c, ndc, viewdirs, fast_embed=fast)
                  for c in (JaxRenderConfig, RenderConfig))
    hwf = (H, W, FOCAL) if ndc else None
    jopt = optax.adam(LR, b1=0.9, b2=0.999)
    jstep = jsteps.make_teacher_train_step(jm, jopt, jcfg, hwf=hwf, jit=False)
    jstate = jsteps.init_train_state(params, jopt)

    models = {name: _torch_model(p, kw) for name, p in params.items()}
    fine = models.get("fine")
    opt = torch.optim.Adam([p for m in models.values() for p in m.parameters()],
                           lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = make_teacher_train_step(models["coarse"], fine, opt, tcfg, hwf=hwf,
                                   device="cpu")
    state = init_train_state(torch.nn.ModuleDict(models), opt)

    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(7), 3)):
        o, d, t = _rays(rng, ndc)
        jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)
        loss_fn = _jax_loss(jm, jcfg, key, jo, jd, jt, hwf)
        want_loss, grads = jax.value_and_grad(loss_fn)(jstate.params)
        jstate, jmet = jstep(jstate, key, jo, jd, jt)
        state, met = step(state, None, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(t), noise=_jax_draws(key))
        assert state.step == i + 1
        # the reference gradients are those of the JAX step's own loss
        np.testing.assert_allclose(float(jmet["loss"]), float(want_loss), rtol=1e-6)
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=LOSS_RTOL,
                                       err_msg=k)
        for name, model in models.items():
            g = _state_dict_np(grads[name], viewdirs)
            w = _state_dict_np(jstate.params[name], viewdirs)
            loose = fast and name == "fine"
            for k, p in model.named_parameters():
                diff = p.grad.numpy() - g[k]
                err = (np.linalg.norm(diff) / np.linalg.norm(g[k]) if loose
                       else np.abs(diff).max() / np.abs(g[k]).max())
                assert err <= (FAST_FINE_GRAD_NORM if loose else GRAD_TOL), (name, k, i, err)
                moved = np.abs(p.detach().numpy() - w[k]).max() / LR
                assert moved <= (FAST_FINE_PARAM_TOL_LR if loose else PARAM_TOL_LR), \
                    (name, k, i, moved)


def test_teacher_train_step_learns(rng):
    """The counterpart of tests/test_train.py::test_teacher_train_step_learns:
    twenty steps on one batch, with the generator's draws."""
    cfg = RenderConfig(n_samples=8, n_importance=4, perturb=True,
                       use_viewdirs=False, near=2.0, far=6.0)
    torch.manual_seed(0)
    model = NeRFMLP(depth=2, width=16, input_ch_views=0, use_viewdirs=False)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    step = make_teacher_train_step(model, None, opt, cfg, device="cpu")
    state = init_train_state(torch.nn.ModuleDict({"coarse": model}), opt)
    o, d, t = (torch.from_numpy(x) for x in _rays(rng, False))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(20):
        state, m = step(state, gen, o, d, t)
        losses.append(float(m["loss"]))
    assert state.step == 20 and losses[-1] < losses[0]


def test_teacher_step_applies_ndc_with_pre_ndc_viewdirs(rng):
    """The counterpart of tests/test_train.py::
    test_teacher_step_applies_ndc_with_pre_ndc_viewdirs: with cfg.ndc the
    step takes raw world rays, normalises viewdirs from the pre-NDC dirs and
    projects o/d; its loss equals that composition by hand and differs from
    both wrong orderings."""
    cfg = RenderConfig(n_samples=8, n_importance=4, perturb=False, use_viewdirs=True,
                       ndc=True, near=0.0, far=1.0)
    torch.manual_seed(5)
    model = NeRFMLP(depth=2, width=16)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    with pytest.raises(ValueError, match="hwf"):
        make_teacher_train_step(model, None, opt, cfg, device="cpu")
    o, d, t = (torch.from_numpy(x) for x in _rays(rng, True))

    def manual_loss(o2, d2, viewdir_src):
        vd = viewdir_src / torch.linalg.norm(viewdir_src, dim=-1, keepdim=True)
        with torch.no_grad():
            res = render_rays(model, None, o2, d2, vd, cfg)
        return float(torch.mean((res.rgb - t) ** 2) + torch.mean((res.rgb0 - t) ** 2))

    no, nd = ndc_rays(H, W, FOCAL, 1.0, o, d)
    correct = manual_loss(no, nd, d)
    wrong_post_ndc_vd = manual_loss(no, nd, nd)
    wrong_unprojected = manual_loss(o, d, d)
    step = make_teacher_train_step(model, None, opt, cfg, hwf=(H, W, FOCAL), device="cpu")
    _, m = step(init_train_state(model, opt), None, o, d, t)
    np.testing.assert_allclose(float(m["loss"]), correct, rtol=1e-6)
    assert abs(correct - wrong_post_ndc_vd) > 1e-6
    assert abs(correct - wrong_unprojected) > 1e-6


@pytest.mark.parametrize("kw", [dict(fused_teacher=True), dict(teacher_quant="int8"),
                                dict(frame_fused=True, fused_teacher=True, perturb=False)])
def test_kernel_paths_raise_under_autograd(kw, rng):
    """The kernels have no backward: a kernel path under autograd raises,
    in the step and in render_rays; under torch.no_grad() it renders."""
    cfg = RenderConfig(n_samples=16, n_importance=16, near=2.0, far=6.0, **kw)
    torch.manual_seed(0)
    model = NeRFMLP(depth=6, width=32)
    opt = torch.optim.Adam(model.parameters())
    step = make_teacher_train_step(model, None, opt, cfg, device="cpu")
    o, d, t = (torch.from_numpy(x) for x in _rays(rng, False))
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    with pytest.raises(RuntimeError, match="no backward"):
        step(init_train_state(model, opt), None, o, d, t)
    with pytest.raises(RuntimeError, match="no backward"):
        render_rays(model, None, o, d, vd, cfg)
    with torch.no_grad():
        res = render_rays(model, None, o, d, vd, cfg)
    assert res.rgb.shape == (B, 3) and torch.isfinite(res.rgb).all()


def test_teacher_step_refuses_a_model_on_another_device(rng):
    model = NeRFMLP(depth=2, width=16)
    opt = torch.optim.Adam(model.parameters())
    cfg = RenderConfig(n_samples=8, n_importance=4)
    with pytest.raises(ValueError, match="model.to"):
        make_teacher_train_step(model, None, opt, cfg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_teacher_train_step(model, None, opt, cfg)


def test_fine_sigma_noise_comes_from_the_generator(rng):
    """raw_noise_std > 0: the coarse pass's noise comes through the hook,
    the fine pass's from `generator` (the JAX step draws it from its key;
    the port has no hook for it, as the JAX renderer has none)."""
    cfg = RenderConfig(n_samples=8, n_importance=8, raw_noise_std=1.0, near=2.0, far=6.0)
    torch.manual_seed(1)
    model = NeRFMLP(depth=2, width=16)
    o, d, _ = (torch.from_numpy(x) for x in _rays(rng, False))
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    hooks = dict(t_rand=torch.rand(B, 8), u=torch.rand(B, 8),
                 noise=torch.randn(B, 8))

    def render(seed):
        with torch.no_grad():
            return render_rays(model, None, o, d, vd, cfg,
                               generator=torch.Generator().manual_seed(seed), **hooks)

    a, b, c = render(3), render(3), render(4)
    assert torch.equal(a.rgb, b.rgb) and torch.equal(a.rgb0, c.rgb0)
    assert not torch.equal(a.rgb, c.rgb)
    # and the fine noise is drawn: without it the fine pass differs
    with torch.no_grad():
        quiet = render_rays(model, None, o, d, vd, dataclasses.replace(
            cfg, raw_noise_std=0.0), **hooks)
    assert not torch.equal(a.rgb, quiet.rgb)
