"""The port's serving entry points against the JAX package's on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core.poses import pose_spherical
from efficient_nerf_tpu.models import R2LNet as JaxR2LNet
from efficient_nerf_tpu.render import r2l_renderer as jren
from efficient_nerf_tpu.core.rays import get_rays as jax_get_rays
from efficient_nerf_tpu.ops.pallas import r2l_int8 as jint8
from efficient_nerf_tpu_torch.models import NeRFMLP, R2LNet
from efficient_nerf_tpu_torch.ops import (pack_nerf_weights, pack_r2l_weights,
                                          pack_r2l_weights_int8, r2l_forward_int8)
from efficient_nerf_tpu_torch.render import (calibrate_serving_scales, make_r2l_forward,
                                             r2l_forward_rays, r2l_render_image)
from efficient_nerf_tpu_torch.render import _pack_cache
from efficient_nerf_tpu_torch.render import renderer as teacher_renderer
from efficient_nerf_tpu_torch.render.r2l_renderer import _packed

N_SAMPLE, L, DEPTH, WIDTH = 4, 10, 6, 32
NEAR, FAR, H, W, FOCAL = 2.0, 6.0, 8, 8, 9.0
# Both sides run the unfused path in f32 with the exact embed at up to 2^9 x
# |p| rad; a one-ulp difference in a sample point moves a top-octave feature
# by ~1e-4, which the net carries to the output at about the same size.
TOL = 1e-4
# int8: the JAX package's tolerance for its int8 kernel against its twin
# (tests/test_ops.py:259); a one-ulp difference before a quantizer moves an
# activation by one int8 level
TOL_INT8 = 1e-2


def _models(plucker, rng):
    input_dim = (6 if plucker else 3 * N_SAMPLE) * (2 * L + 1)
    jm = JaxR2LNet(input_dim=input_dim, depth=DEPTH, width=WIDTH)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, input_dim)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)
                   ).astype(np.float32), p)
    return jm, params, R2LNet(input_dim, DEPTH, WIDTH).load_jax_params(params)


@pytest.mark.parametrize("plucker", [False, True])
def test_forward_rays_matches_jax(plucker, rng):
    jm, params, tm = _models(plucker, rng)
    o = rng.normal(size=(37, 3)).astype(np.float32)
    d = rng.normal(size=(37, 3)).astype(np.float32)
    want = np.asarray(jren.r2l_forward_rays(jm, params, jnp.asarray(o),
                                            jnp.asarray(d), NEAR, FAR,
                                            N_SAMPLE, L, plucker=plucker))
    got = r2l_forward_rays(tm, o, d, NEAR, FAR, N_SAMPLE, L, plucker=plucker,
                           device="cpu")
    assert got.shape == (37, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    fn = make_r2l_forward(tm, NEAR, FAR, N_SAMPLE, L, plucker=plucker,
                          device="cpu")
    np.testing.assert_array_equal(fn(o, d).numpy(), got.numpy())


@pytest.mark.parametrize("chunk", [0, 24])
@pytest.mark.parametrize("plucker", [False, True])
def test_render_image_matches_jax(plucker, chunk, rng):
    jm, params, tm = _models(plucker, rng)
    c2w = pose_spherical(45.0, -30.0, 4.0)[:3, :4]
    want = np.asarray(jren.r2l_render_image(jm, params, jnp.asarray(c2w), H, W,
                                            FOCAL, NEAR, FAR, N_SAMPLE, L,
                                            plucker=plucker, chunk=chunk))
    got = r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L,
                           plucker=plucker, chunk=chunk, device="cpu")
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_entry_points_raise_without_device_when_cuda_is_absent(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    _, _, tm = _models(False, rng)
    o = np.zeros((4, 3), np.float32)
    c2w = pose_spherical(0.0, -30.0, 4.0)[:3, :4]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_r2l_forward(tm, NEAR, FAR, N_SAMPLE, L)


def test_int8_and_unknown_quant_raise(rng):
    # int8 needs the fused profile on every device, as the JAX package's
    # int8 branch does (r2l_renderer.py:77-79)
    _, _, tm = _models(False, rng)
    o = np.zeros((4, 3), np.float32)
    c2w = pose_spherical(0.0, -30.0, 4.0)[:3, :4]
    with pytest.raises(ValueError, match="int8"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L, quant="int8",
                         allow_fused=False, device="cpu")
    _, _, pm = _models(True, rng)
    with pytest.raises(ValueError, match="int8"):
        r2l_render_image(pm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L, plucker=True,
                         quant="int8", device="cpu")
    lin = R2LNet(3 * N_SAMPLE * (2 * L + 1), DEPTH, WIDTH, linear_tail=True)
    with pytest.raises(ValueError, match="int8"):
        r2l_forward_rays(lin, o, o, NEAR, FAR, N_SAMPLE, L, quant="int8", device="cpu")
    with pytest.raises(ValueError, match="quant"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L, quant="fp8",
                         device="cpu")
    with pytest.raises(ValueError, match="quant"):
        r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L, quant="fp8",
                         device="cpu")


@pytest.mark.parametrize("scales", ["self", "given"])
def test_int8_render_image_matches_jax(scales, rng):
    # the JAX package's int8 path, composed as its r2l_render_image composes
    # it on the TPU: get_rays -> calibrate_r2l_int8 on the first 1024 rays ->
    # r2l_forward_int8, here in interpret mode (its CPU branch raises)
    jm, params, tm = _models(False, rng)
    c2w = pose_spherical(45.0, -30.0, 4.0)[:3, :4]
    ro, rd = jax_get_rays(H, W, FOCAL, jnp.asarray(c2w))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    act = jint8.calibrate_r2l_int8(params, ro[:1024], rd[:1024], NEAR, FAR, N_SAMPLE, L)
    want = np.asarray(jint8.r2l_forward_int8(
        params, ro, rd, NEAR, FAR, N_SAMPLE, L, tile_b=H * W, act_scales=act,
        interpret=True)).reshape(H, W, 3)
    given = (calibrate_serving_scales(tm, np.asarray(ro), np.asarray(rd), NEAR, FAR,
                                      N_SAMPLE, L, device="cpu")
             if scales == "given" else None)
    launches = r2l_forward_int8.launches
    got = r2l_render_image(tm, c2w, H, W, FOCAL, NEAR, FAR, N_SAMPLE, L, quant="int8",
                           device="cpu", act_scales=given)
    assert r2l_forward_int8.launches == launches   # the CPU runs the plain version
    assert got.shape == (H, W, 3) and got.device.type == "cpu"
    # measured: max 1.4e-3, mean 3.0e-5
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_INT8)
    assert np.abs(got.numpy() - want).mean() <= 1e-3


def test_calibrate_serving_scales_matches_jax(rng):
    jm, params, tm = _models(False, rng)
    o = rng.normal(size=(300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    want = np.asarray(jren.calibrate_serving_scales(
        jm, params, jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L, n_cal=200))
    got = calibrate_serving_scales(tm, o, d, NEAR, FAR, N_SAMPLE, L, n_cal=200,
                                   device="cpu")
    assert got.shape == ((DEPTH - 2) // 2, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_int8_forward_rays_serves_the_given_scales(rng):
    _, _, tm = _models(False, rng)
    o = rng.normal(size=(37, 3)).astype(np.float32)
    d = rng.normal(size=(37, 3)).astype(np.float32)
    act = calibrate_serving_scales(tm, o[:16], d[:16], NEAR, FAR, N_SAMPLE, L,
                                   device="cpu")
    got = r2l_forward_rays(tm, o, d, NEAR, FAR, N_SAMPLE, L, quant="int8",
                           act_scales=act.numpy(), device="cpu")
    want = r2l_forward_int8(pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L),
                            torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR,
                            N_SAMPLE, L, act_scales=act)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # without scales, the call calibrates on its own first 1024 rays
    self_cal = r2l_forward_rays(tm, o, d, NEAR, FAR, N_SAMPLE, L, quant="int8",
                                device="cpu")
    want = r2l_forward_int8(pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L),
                            torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR,
                            N_SAMPLE, L, act_scales=calibrate_serving_scales(
                                tm, o, d, NEAR, FAR, N_SAMPLE, L, device="cpu"))
    torch.testing.assert_close(self_cal, want, atol=0, rtol=0)


def test_a_fused_optimizer_step_repacks_the_int8_weights(rng):
    _, _, tm = _models(False, rng)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, fused=True)
    before = _packed(tm, N_SAMPLE, L, "int8")
    assert _packed(tm, N_SAMPLE, L, "int8") is before     # cached while unchanged
    assert before["body_qw"].dtype == torch.int8
    assert _packed(tm, N_SAMPLE, L) is not before          # the bf16 pack is apart
    for p in tm.parameters():
        p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
    opt.step()
    after = _packed(tm, N_SAMPLE, L, "int8")
    assert after is not before
    assert not torch.equal(after["body_qw"], before["body_qw"])


def test_other_model_types_raise():
    conv = torch.nn.Conv2d(3, 3, 1)
    with pytest.raises(NotImplementedError, match="R2LConvNet"):
        r2l_render_image(conv, np.eye(4)[:3], H, W, FOCAL, NEAR, FAR,
                         N_SAMPLE, L, device="cpu")


def test_model_on_another_device_raises(rng):
    _, _, tm = _models(False, rng)
    o = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="model.to"):
        r2l_forward_rays(tm, o, o, NEAR, FAR, N_SAMPLE, L, device="meta")


# The pack cache's check against the module walk it replaces. Each kind: a
# model (parameters in bf16, so that .to(torch.float32) moves them), a body
# layer, the renderer's pack of the model and a fresh pack of its state dict.
def _student():
    return R2LNet(3 * N_SAMPLE * (2 * L + 1), DEPTH, WIDTH).to(torch.bfloat16)


_PACK_KINDS = {
    "r2l_bf16": (_student, lambda m: m.body[0].body[0],
                 lambda m: _packed(m, N_SAMPLE, L),
                 lambda sd: pack_r2l_weights(sd, N_SAMPLE, L)),
    "r2l_int8": (_student, lambda m: m.body[0].body[0],
                 lambda m: _packed(m, N_SAMPLE, L, "int8"),
                 lambda sd: pack_r2l_weights_int8(sd, N_SAMPLE, L)),
    "teacher": (lambda: NeRFMLP(depth=8, width=32).to(torch.bfloat16),
                lambda m: m.pts_linears[1],
                lambda m: teacher_renderer._packed(m, on_card=False),
                lambda sd: pack_nerf_weights(sd, skip=4, dtype=torch.float32)),
}


def _walked_key(model):
    """The key a pack was valid for before the check: the optimizer steps
    and every parameter's storage and version, by a walk of the module tree."""
    return (_pack_cache._optimizer_steps,) + tuple(
        (p.data_ptr(), p._version) for p in model.parameters())


def _random_state(model, rng):
    return {k: torch.from_numpy(rng.normal(scale=0.1, size=v.shape)).to(v.dtype)
            for k, v in model.state_dict().items()}


def _adam_step(model, rng, **kw):
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, **kw)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.normal(size=p.shape)).to(p.dtype)
    opt.step()


def _to_f32_replacing(model):
    # a conversion that replaces each parameter object (no registration hook)
    torch.__future__.set_overwrite_module_params_on_conversion(True)
    try:
        model.to(torch.float32)
    finally:
        torch.__future__.set_overwrite_module_params_on_conversion(False)


def _body_layers(model):
    """The parents of two of the body's W x W layers, and their names."""
    if isinstance(model, R2LNet):
        return model.body[0].body, "0", model.body[1].body, "0"
    return model.pts_linears, "1", model.pts_linears, "2"


def _new_body_layer(model):
    parent, name, _, _ = _body_layers(model)
    setattr(parent, name, torch.nn.Linear(WIDTH, WIDTH))


def _swap_body_layers(model):
    # existing layers change places: no parameter is registered, no
    # parameter changes its storage or version, only the tree changes
    p1, n1, p2, n2 = _body_layers(model)
    a, b = getattr(p1, n1), getattr(p2, n2)
    setattr(p1, n1, b)
    setattr(p2, n2, a)


_MUTATIONS = {
    "load_state_dict": lambda m, layer, rng: m.load_state_dict(_random_state(m, rng)),
    "load_state_dict_assign": lambda m, layer, rng: m.load_state_dict(
        _random_state(m, rng), assign=True),
    "mul_": lambda m, layer, rng: layer.weight.mul_(0.5),
    "adam_foreach": lambda m, layer, rng: _adam_step(m, rng, foreach=True),
    "adam_fused": lambda m, layer, rng: _adam_step(m, rng, fused=True),
    "to_float32": lambda m, layer, rng: m.to(torch.float32),
    "to_float32_replacing": lambda m, layer, rng: _to_f32_replacing(m),
    "new_parameter": lambda m, layer, rng: setattr(layer, "weight", torch.nn.Parameter(
        torch.from_numpy(rng.normal(size=layer.weight.shape)).to(layer.weight.dtype))),
    "added_parameter": lambda m, layer, rng: setattr(
        layer, "gain", torch.nn.Parameter(torch.ones(WIDTH, dtype=layer.weight.dtype))),
    "new_submodule": lambda m, layer, rng: _new_body_layer(m),
    "swap_submodules": lambda m, layer, rng: _swap_body_layers(m),
}


def _same_pack(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_pack(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_pack(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("mutation", sorted(_MUTATIONS))
@pytest.mark.parametrize("kind", sorted(_PACK_KINDS))
def test_pack_is_made_again_exactly_when_the_walked_key_changes(kind, mutation, rng):
    make_model, body_layer, packed, fresh = _PACK_KINDS[kind]
    model = make_model()
    with torch.no_grad():
        first = packed(model)
        builds, key = _pack_cache.pack_builds, _walked_key(model)
        assert packed(model) is first
        _MUTATIONS[mutation](model, body_layer(model), rng)
    assert _walked_key(model) != key          # each mutation changes the walked key
    with torch.no_grad():
        got = packed(model)
        assert packed(model) is got           # and the new pack is kept
    assert _pack_cache.pack_builds - builds == 1
    assert _same_pack(got, fresh(model.state_dict()))


@pytest.mark.parametrize("kind", sorted(_PACK_KINDS))
def test_an_unchanged_model_is_packed_once_without_a_walk(kind, monkeypatch):
    make_model, _, packed, _ = _PACK_KINDS[kind]
    model = make_model()
    first = packed(model)
    builds, hits = _pack_cache.pack_builds, _pack_cache.pack_hits
    walks = []
    for name in ("named_modules", "_named_members"):
        real = getattr(torch.nn.Module, name)
        monkeypatch.setattr(torch.nn.Module, name,
                            lambda self, *a, _real=real, _n=name, **k: (
                                walks.append(_n), _real(self, *a, **k))[1])
    for _ in range(20):
        assert packed(model) is first
    assert _pack_cache.pack_builds - builds == 0
    assert _pack_cache.pack_hits - hits == 20
    assert walks == []


def test_a_module_made_elsewhere_keeps_the_pack():
    # a registration anywhere in the process bumps the structure epoch: the
    # next call walks the tree, finds the walked key unchanged, keeps the
    # pack and takes the new epoch, so that the call after it needs no walk
    model = _student()
    first = _packed(model, N_SAMPLE, L)
    epoch, builds = _pack_cache._structure_epoch, _pack_cache.pack_builds
    torch.nn.Linear(4, 4)
    assert _pack_cache._structure_epoch > epoch
    assert _packed(model, N_SAMPLE, L) is first
    assert _pack_cache.pack_builds == builds
    assert vars(model)["_fused_pack"].epoch == _pack_cache._structure_epoch
