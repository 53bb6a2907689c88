"""The teacher renderer against the JAX package: render_rays/render_image in
eval mode against the JAX fused path (its Pallas field-eval and sampler
kernels in interpret mode, switched on here by monkeypatching the JAX ops
gate; nothing in the JAX package changes), the int8 teacher against the JAX
int8 path (its jnp twin off the TPU), the whole-ray path against the JAX
frame kernel in interpret mode, the perturbed and noisy path with the
determinism hooks against the JAX XLA path, lindisp, NDC and white_bkgd,
and the modes that raise."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficient_nerf_tpu.ops as jops
from efficient_nerf_tpu.core.poses import pose_spherical
from efficient_nerf_tpu.ops.pallas import nerf_forward as jnf
from efficient_nerf_tpu.ops.pallas import sample_pdf as jsp
from efficient_nerf_tpu.render import renderer as JR
from efficient_nerf_tpu_torch.models import NeRFMLP
from efficient_nerf_tpu_torch.ops import nerf_forward as nf
from efficient_nerf_tpu_torch.ops import sample_pdf as sp
from efficient_nerf_tpu_torch.render import renderer as R

DEPTH, WIDTH, H, W, FOCAL = 8, 64, 12, 12, 15.0
# coarse outputs: f32 field evals that differ by summation order (3e-4 on
# raw, tests/test_torch_nerf_forward.py) and the same composite. Fine
# outputs: the fine depths come from the sampler, whose weight total is
# summed sequentially here and by XLA's reduction there; that moves a depth
# by up to ~1e-5 (tests/test_torch_sample_pdf.py), and the point's 2^9
# frequency turns it into ~5e-3 rad of phase in the fine field. And the
# fine pass is not continuous in the coarse weights (a level in an interval
# below the sampler's 1e-5 guard jumps; the last sample stands for a
# 1e10-long interval): up to FINE_SHARE of the rays may differ by more.
TOL = {"rgb0": 1e-4, "acc0": 1e-4, "disp0": 1e-3,
       "rgb": 2e-3, "acc": 2e-3, "disp": 5e-3, "depth": 1e-2, "z_std": 2e-3}
FINE = ("rgb", "acc", "disp", "depth", "z_std")
FINE_SHARE = 0.02
# The int8 teacher against the JAX renderer, which runs its int8 functions
# under jit: there XLA turns the pack's and the calibration's divisions into
# multiplications by reciprocals, and 24 of 448 weight scales (and the
# activation scales) land an ulp away from the eager JAX functions that the
# port follows bit for bit (tests/test_torch_nerf_int8.py). Such an ulp moves
# an activation across a quantizer's rounding boundary now and then: one
# int8 level, about 1e-3 of rgb and acc (disp = acc / depth moves most where
# acc is small). The fine pass keeps FINE_SHARE; in the coarse pass a ray
# whose every sigma sits within a level of 0 turns empty (acc 0, disp NaN)
# or not, so INT8_COARSE_SHARE of its rays may differ too.
INT8_COARSE_SHARE = 0.01
INT8_TOL = {"rgb0": 1e-2, "acc0": 1e-2, "disp0": 5e-2,
            "rgb": 1e-2, "acc": 1e-2, "disp": 5e-2, "depth": 5e-2, "z_std": 2e-3}


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX renderer's fused eval path on the CPU: its gate opened, its
    Pallas kernels in interpret mode."""
    monkeypatch.setattr(jops, "fused_nerf_available", lambda: True)
    monkeypatch.setattr(jops, "nerf_forward_fused",
                        functools.partial(jnf.nerf_forward_fused, interpret=True))
    monkeypatch.setattr(jops, "sample_pdf_det_fused",
                        functools.partial(jsp.sample_pdf_det_fused, interpret=True))


def _models(rng, **kw):
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=DEPTH, width=WIDTH, **kw)
    n_in = jm.input_ch + jm.input_ch_views
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, n_in)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.05, size=v.shape)
                   ).astype(np.float32), p)
    return jm, params, NeRFMLP(depth=DEPTH, width=WIDTH, **kw).load_jax_params(params)


def _compare(got, want, tol=TOL, fine_share=FINE_SHARE, coarse_share=0.0):
    n_rays = np.asarray(want.acc).size
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).detach().numpy()
        assert a.shape == b.shape, name
        nan = np.isnan(a) | np.isnan(b)
        diff = np.where(nan, 0, np.abs(b - a)).reshape(n_rays, -1).max(-1)
        beyond = (diff > tol.get(name, 0.0)) | \
            (np.isnan(a) != np.isnan(b)).reshape(n_rays, -1).any(-1)
        share = fine_share if name in FINE else coarse_share
        assert beyond.mean() <= share, (name, int(beyond.sum()), diff.max())


def _configs(**kw):
    base = dict(n_samples=16, n_importance=16, near=2.0, far=6.0, chunk=64)
    base.update(kw)
    return JR.RenderConfig(**base).eval_mode(), R.RenderConfig(**base).eval_mode()


@pytest.mark.parametrize("white,lindisp,ndc", [(True, False, False),
                                               (False, True, False),
                                               (False, False, True)])
def test_render_image_eval_matches_jax_fused(white, lindisp, ndc, rng, jax_fused):
    jm, params, tm = _models(rng)
    kw = dict(white_bkgd=white, lindisp=lindisp, ndc=ndc)
    if ndc:
        kw.update(near=0.0, far=1.0)
    jcfg, tcfg = _configs(**kw)
    assert tcfg.fused_teacher and R._nerf_profile_ok(tm, tcfg)
    c2w = pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    want = JR.render_image(jm, params, params, H, W, FOCAL, jnp.asarray(c2w), jcfg)
    n0, s0 = nf.nerf_forward_fused.launches, sp.sample_pdf_det_fused.launches
    got = R.render_image(tm, None, H, W, FOCAL, c2w, tcfg, device="cpu")
    # the CPU runs the kernels' plain versions: no launch
    assert (nf.nerf_forward_fused.launches, sp.sample_pdf_det_fused.launches) == (n0, s0)
    assert got.rgb.shape == (H, W, 3) and got.z_std.shape == (H, W)
    _compare(got, want)


def test_render_rays_eval_with_a_fine_model(rng, jax_fused):
    jm, params, tm = _models(rng)
    _, params_f, tm_f = _models(rng)
    jcfg, tcfg = _configs(white_bkgd=True)
    # as many rays as a frame of the other tests: the JAX kernels' shapes
    # (and so their interpret-mode traces) are theirs
    o = rng.normal(size=(64, 3)).astype(np.float32) * 0.2
    d = (rng.normal(size=(64, 3)) * 0.3 + [0, 0, -1]).astype(np.float32)
    o[:, 2] += 4.0
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    want = JR.render_rays(jm, params, params_f, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(vd), None, jcfg)
    # the kernel paths have no backward: evaluation runs without autograd
    with torch.no_grad():
        got = R.render_rays(tm, tm_f, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(vd), tcfg)
    _compare(got, want)


def test_perturbed_path_with_hooks_matches_jax_xla(rng):
    """Training-mode sampling (perturb, the u hook): both packages take their
    unfused path (fused_teacher is off outside eval_mode)."""
    jm, params, tm = _models(rng)
    base = dict(n_samples=16, n_importance=16, perturb=True, white_bkgd=True,
                fast_embed=False)
    jcfg, tcfg = JR.RenderConfig(**base), R.RenderConfig(**base)
    assert not R._nerf_profile_ok(tm, tcfg)
    N = 9
    o = rng.normal(size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_rand = rng.uniform(size=(N, 16)).astype(np.float32)
    u = rng.uniform(size=(N, 16)).astype(np.float32)
    want = JR.render_rays(jm, params, params, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(vd), None, jcfg, t_rand=jnp.asarray(t_rand),
                          u=jnp.asarray(u))
    got = R.render_rays(tm, None, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(vd), tcfg, t_rand=torch.from_numpy(t_rand),
                        u=torch.from_numpy(u))
    # f32 XLA against torch on the same exact embed: the sampler's cumsum
    # order moves fine depths by ~1e-6 here
    _compare(got, want, {k: 1e-3 for k in want._fields}, fine_share=0.0)


def test_noisy_coarse_pass_with_hooks_matches_jax_xla(rng):
    jm, params, tm = _models(rng)
    base = dict(n_samples=16, n_importance=0, perturb=True, raw_noise_std=1.0,
                fast_embed=False, near=1.5, far=5.0)
    jcfg, tcfg = JR.RenderConfig(**base), R.RenderConfig(**base)
    N = 7
    o = rng.normal(size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_rand = rng.uniform(size=(N, 16)).astype(np.float32)
    noise = rng.normal(size=(N, 16)).astype(np.float32)
    near = rng.uniform(1.0, 2.0, size=(N, 1)).astype(np.float32)
    want = JR.render_rays(jm, params, None, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(vd), None, jcfg, near=jnp.asarray(near),
                          t_rand=jnp.asarray(t_rand), noise=jnp.asarray(noise))
    got = R.render_rays(tm, None, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(vd), tcfg, near=torch.from_numpy(near),
                        t_rand=torch.from_numpy(t_rand), noise=torch.from_numpy(noise))
    _compare(got, want, {k: 1e-5 for k in want._fields}, fine_share=0.0)


def test_render_image_chunking_and_make_ray_renderer(rng):
    _, _, tm = _models(rng)
    _, tcfg = _configs(white_bkgd=True)
    c2w = pose_spherical(10.0, -20.0, 4.0)[:3, :4]
    a = R.render_image(tm, None, 6, 5, 7.0, c2w, tcfg, device="cpu")
    b = R.render_image(tm, None, 6, 5, 7.0, c2w, dataclasses.replace(tcfg, chunk=7),
                       device="cpu")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0, equal_nan=True)
    fn = R.make_ray_renderer(tm, tcfg)
    o = torch.zeros(3, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    with torch.no_grad():   # the eval config's kernel paths have no backward
        out = fn(None, o + torch.tensor([0.0, 0.0, 4.0]), d, d)
    assert out.rgb.shape == (3, 3)


def test_modes_that_are_not_ported_raise(rng):
    """Every mode is ported now; what still raises: an unknown
    teacher_quant, the int8 teacher on a model outside the teacher profile,
    and the whole-ray path with coarse and fine models that differ."""
    _, _, tm = _models(rng)
    o = torch.zeros(2, 3)
    no_skip = NeRFMLP(depth=4, width=32, skips=())
    narrow = NeRFMLP(depth=DEPTH, width=32)
    frame = dict(frame_fused=True, n_samples=16, n_importance=16)
    for model, fine, kw, match in ((tm, None, dict(teacher_quant="fp4"), "unknown"),
                                   (no_skip, None, dict(teacher_quant="int8"), "profile"),
                                   (tm, narrow, frame, "matching coarse/fine"),
                                   (tm, no_skip, frame, "matching coarse/fine")):
        cfg = R.RenderConfig(**{"n_samples": 8, "n_importance": 8, **kw}).eval_mode()
        # without autograd, as evaluation runs: under it a kernel path raises
        # for that first (test_torch_teacher_train.py)
        with pytest.raises(ValueError, match=match), torch.no_grad():
            R.render_rays(model, fine, o, o + 1, o + 1, cfg)
        with pytest.raises(ValueError, match=match):
            R.render_image(model, fine, 2, 2, 3.0, np.eye(4)[:3], cfg, device="cpu")


def test_render_image_int8_matches_jax(rng):
    """teacher_quant='int8' in eval mode: off the TPU the JAX renderer takes
    its XLA path with the int8 jnp twin (no monkeypatch), the port the int8
    kernel's plain version and the sampler's (FINE_SHARE covers the
    sampler's summation order, as above). Chunks of 48 rays divide the frame,
    so that each call's calibration points are the same on both sides (the
    JAX renderer pads the last chunk with zero rays)."""
    from efficient_nerf_tpu_torch.ops import nerf_int8 as ni

    jm, params, tm = _models(rng)
    jcfg, tcfg = _configs(white_bkgd=True, teacher_quant="int8", chunk=48)
    c2w = pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    want = JR.render_image(jm, params, params, H, W, FOCAL, jnp.asarray(c2w), jcfg)
    n0 = ni.nerf_forward_int8.launches
    got = R.render_image(tm, None, H, W, FOCAL, c2w, tcfg, device="cpu")
    assert ni.nerf_forward_int8.launches == n0   # CPU: the plain version
    _compare(got, want, INT8_TOL, coarse_share=INT8_COARSE_SHARE)
    # the int8 path was taken: the f32 teacher's coarse colours differ by more
    # than the f32 comparisons allow (3.3e-3 here)
    plain = R.render_image(tm, None, H, W, FOCAL, c2w, dataclasses.replace(
        tcfg, teacher_quant=""), device="cpu")
    assert (plain.rgb0 - got.rgb0).abs().max() > 10 * TOL["rgb0"]


def test_render_image_frame_fused_matches_jax(rng, monkeypatch):
    """frame_fused in eval mode: the JAX renderer's frame kernel in interpret
    mode (switched on as tests/test_renderer.py:133 does) against the port's
    whole-ray path, whose plain version runs on the CPU."""
    from efficient_nerf_tpu_torch.ops import nerf_frame as fr

    monkeypatch.setattr(JR, "_FRAME_INTERPRET", True)
    jm, params, tm = _models(rng)
    jcfg, tcfg = _configs(white_bkgd=True, frame_fused=True, frame_tile_r=16)
    assert JR._frame_fused_eligible(jm, jcfg, None, None, None, None, None)
    assert R._frame_fused_eligible(tm, tcfg, None, None, None, None, None)
    for bad in (dict(perturb=True), dict(n_importance=0), dict(n_samples=20),
                dict(teacher_quant="int8"), dict(raw_noise_std=1.0)):
        assert not R._frame_fused_eligible(tm, dataclasses.replace(tcfg, **bad), None, None,
                                           None, None, None), bad
    for hooks in ((2.5, None, None, None, None), (None, None, None, None, torch.zeros(1))):
        assert not R._frame_fused_eligible(tm, tcfg, *hooks)
    c2w = pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    want = JR.render_image(jm, params, params, H, W, FOCAL, jnp.asarray(c2w), jcfg)
    n0 = fr.nerf_render_rays_fused.launches
    got = R.render_image(tm, None, H, W, FOCAL, c2w, tcfg, device="cpu")
    assert fr.nerf_render_rays_fused.launches == n0   # CPU: the plain version
    _compare(got, want)


def _kernel_weight_dtypes(monkeypatch, name):
    """Stand in for the renderer's kernel `name`: record the dtype of the
    weights that each call is handed and return zeros of the output's shape."""
    seen = []

    def fake(packed, *a, **kw):
        seen.append(packed["pts0_w"].dtype)
        if name == "nerf_render_rays_fused":
            n = a[1].shape[0]
            return tuple(torch.zeros((n, 3) if i in (0, 4) else (n,)) for i in range(8))
        return torch.zeros(a[0].shape[:-1] + (4,))

    monkeypatch.setattr(R, name, fake)
    return seen


def test_fused_eval_on_the_card_needs_bf16(rng, monkeypatch):
    """The card's field-eval kernel takes bf16 weights: an f32 teacher on a
    CUDA tensor hands it a bf16 pack and keeps its own f32 parameters (a
    CPU tensor that claims to be on the card shows it); on the CPU the plain
    version takes the model's f32."""
    _, _, tm = _models(rng)
    _, tcfg = _configs()
    seen = _kernel_weight_dtypes(monkeypatch, "nerf_forward_fused")
    args = (torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2, 16), torch.zeros(2, 3), tcfg,
            True)
    with torch.no_grad():
        R._field(tm, *args)
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        R._field(tm, *args)
    assert seen == [torch.float32, torch.bfloat16]
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("kw", [dict(teacher_quant="int8"), dict(frame_fused=True)])
def test_int8_and_whole_ray_paths_on_the_card_need_bf16(kw, rng, monkeypatch):
    """As above for the int8 field eval and the whole-ray kernel."""
    _, _, tm = _models(rng)
    _, tcfg = _configs(**kw)
    name = "nerf_forward_int8" if kw.get("teacher_quant") else "nerf_render_rays_fused"
    seen = _kernel_weight_dtypes(monkeypatch, name)
    monkeypatch.setattr(R, "sample_pdf_det_fused", sp.sample_pdf_det_fused_ref)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    o = torch.zeros(2, 3)
    with torch.no_grad():
        R.render_rays(tm, None, o, o + 1, o + 1, tcfg)
    assert seen and set(seen) == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("kw", [dict(use_viewdirs=False), dict(skips=(2, 5))])
def test_a_teacher_off_the_kernel_profile_renders_in_its_own_dtype(kw, rng, monkeypatch):
    """A teacher that no kernel covers (no viewdir branch, two skips) takes
    the unfused path in eval mode on the card too, in its own f32: no
    kernel is reached and nothing is packed."""
    _, _, tm = _models(rng, **kw)
    _, tcfg = _configs(use_viewdirs=kw.get("use_viewdirs", True))
    for name in ("nerf_forward_fused", "sample_pdf_det_fused", "nerf_forward_int8",
                 "nerf_render_rays_fused"):
        monkeypatch.setattr(R, name, lambda *a, _n=name, **k: pytest.fail(_n))
    o = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    d = o / torch.linalg.norm(o, dim=-1, keepdim=True)
    with torch.no_grad():
        want = R.render_rays(tm, None, o, d, d, tcfg)
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        got = R.render_rays(tm, None, o, d, d, tcfg)
    assert all(x.dtype == torch.float32 for x in got) and torch.isfinite(got.rgb).all()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not hasattr(tm, "_nerf_pack")
