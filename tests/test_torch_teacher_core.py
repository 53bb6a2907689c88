"""The teacher slice's core modules against the JAX package: nerf_embed,
depth sampling (linear_zvals with lindisp, stratified_sample, sample_pdf,
merge_sorted), volume compositing, NDC and the origin translations, and the
pose samplers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core import encoding as jenc
from efficient_nerf_tpu.core import poses as jposes
from efficient_nerf_tpu.core import rays as jrays
from efficient_nerf_tpu.core import sampling as jsamp
from efficient_nerf_tpu.core import volume as jvol
from efficient_nerf_tpu_torch.core import encoding, poses, rays, sampling, volume


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fast,tol", [(False, 1e-6), (True, 2e-4)])
@pytest.mark.parametrize("L", [10, 4, 0])
def test_nerf_embed(fast, tol, L, rng):
    """Layout [x, sin(f0 x), cos(f0 x), ...]. Exact: sin/cos of the two
    libraries differ by an ulp. Fast: the double-angle recurrence carries
    that ulp of its base angle through 2^(L-1) (tests/test_ops.py:24 allows
    2e-3 for the same amplification at a larger argument)."""
    x = (rng.normal(size=(7, 5, 3)) * 2).astype(np.float32)
    want = np.asarray(jenc.nerf_embed(jnp.asarray(x), L, fast=fast))
    got = encoding.nerf_embed(_t(x), L, fast=fast).numpy()
    assert got.shape == (7, 5, encoding.nerf_embed_dim(3, L))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("lindisp", [False, True])
def test_linear_zvals_bitwise(lindisp, rng):
    for n in (64, 16, 5):
        got = sampling.linear_zvals(2.0, 6.0, n, lindisp, device="cpu").numpy()
        np.testing.assert_array_equal(got, np.asarray(jsamp.linear_zvals(2.0, 6.0, n, lindisp)))
    near = rng.uniform(0.5, 2.0, size=(9, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 4.0, size=(9, 1)).astype(np.float32)
    got = sampling.linear_zvals(_t(near), _t(far), 32, lindisp).numpy()
    want = np.asarray(jsamp.linear_zvals(jnp.asarray(near), jnp.asarray(far), 32, lindisp))
    assert got.shape == (9, 32)
    np.testing.assert_array_equal(got, want)


def test_stratified_sample_with_hook(rng):
    o = rng.normal(size=(6, 3)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    t = rng.uniform(size=(6, 8)).astype(np.float32)
    jp, jz = jsamp.stratified_sample(None, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0,
                                     8, lindisp=True, t_rand=jnp.asarray(t))
    tp, tz = sampling.stratified_sample(_t(o), _t(d), 2.0, 6.0, 8, lindisp=True,
                                        t_rand=_t(t))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)


def _pdf_inputs(rng, N=23, C=33):
    bins = np.sort(rng.uniform(2.0, 6.0, size=(N, C)).astype(np.float32), -1)
    w = rng.uniform(size=(N, C - 1)).astype(np.float32)
    w[0] = 0.0
    w[1] = 0.0
    w[1, 3] = 50.0
    return bins, w


def test_sample_pdf_det(rng):
    """Below the top level the two differ by the CDF's cumsum order (~1e-7,
    up to ~1e-5 in z: the JAX package's tolerance, tests/test_ops.py:120);
    the top level u = 1 is rounding-ambiguous in both."""
    bins, w = _pdf_inputs(rng)
    want = np.asarray(jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 40, det=True))
    got = sampling.sample_pdf(_t(bins), _t(w), 40, det=True).numpy()
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], atol=5e-5, rtol=0)


def test_sample_pdf_u_hook(rng):
    bins, w = _pdf_inputs(rng)
    u = rng.uniform(size=(23, 40)).astype(np.float32)
    u[2, :4] = 0.0
    want = np.asarray(jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 40,
                                       u=jnp.asarray(u)))
    got = sampling.sample_pdf(_t(bins), _t(w), 40, u=_t(u)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_sample_pdf_random_draws_are_sorted_and_in_range(rng):
    bins, w = _pdf_inputs(rng)
    g = torch.Generator().manual_seed(0)
    u = sampling.sorted_uniform((23, 40), g, device="cpu")
    assert torch.all(u[:, 1:] >= u[:, :-1]) and torch.all((u > 0) & (u < 1))
    s = sampling.sample_pdf(_t(bins), _t(w), 40, sorted_u=True, generator=g)
    assert torch.all(s[:, 1:] >= s[:, :-1])
    assert torch.all((s >= 2.0) & (s <= 6.0))


@pytest.mark.parametrize("m,n", [(64, 128), (16, 16), (5, 11)])
def test_merge_sorted_bitwise(m, n, rng):
    a = np.sort(rng.uniform(2, 6, size=(13, m)).astype(np.float32), -1)
    b = np.sort(rng.uniform(2, 6, size=(13, n)).astype(np.float32), -1)
    a[3, m // 2:] = a[3, m // 2]                    # ties
    b[4, 1], b[4, 2] = b[4, 2], b[4, 1]             # a row an ulp out of order
    b[4, 2] = np.nextafter(b[4, 1], np.float32(0))
    want = np.asarray(jsamp.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    got = sampling.merge_sorted(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)


def _volume_inputs(rng):
    raw = rng.normal(size=(6, 9, 4)).astype(np.float32)
    raw[0, :, 3] = -5.0                     # every sigma clipped: acc = 0
    z = np.sort(rng.uniform(2, 6, size=(6, 9)).astype(np.float32), -1)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    noise = rng.normal(size=(6, 9)).astype(np.float32)
    return raw, z, d, noise


def _assert_outputs_equal(got, want, atol):
    for name, g, w in zip(want._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
        np.testing.assert_allclose(np.where(nan, 0, g), np.where(nan, 0, w),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("std", [0.0, 0.7])
@pytest.mark.parametrize("white", [False, True])
def test_raw2outputs(std, white, rng):
    raw, z, d, noise = _volume_inputs(rng)
    want = jvol.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), std,
                            white, noise=jnp.asarray(noise))
    got = volume.raw2outputs(_t(raw), _t(z), _t(d), std, white, noise=_t(noise))
    assert np.isnan(np.asarray(want.disp)[0])   # 1 / max(1e-10, 0 / 0)
    _assert_outputs_equal(got, want, 1e-6)


@pytest.mark.parametrize("std", [0.0, 0.7])
def test_raw2outputs_cm(std, rng):
    raw, z, d, noise = _volume_inputs(rng)
    cm = np.ascontiguousarray(np.moveaxis(raw, -1, 0))
    want = jvol.raw2outputs_cm(jnp.asarray(cm), jnp.asarray(z), jnp.asarray(d), std,
                               True, noise=jnp.asarray(noise))
    got = volume.raw2outputs_cm(_t(cm), _t(z), _t(d), std, True, noise=_t(noise))
    _assert_outputs_equal(got, want, 1e-6)
    x = rng.uniform(size=(4, 7)).astype(np.float32)
    np.testing.assert_allclose(volume.exclusive_cumprod(_t(x)).numpy(),
                               np.asarray(jvol.exclusive_cumprod(jnp.asarray(x))),
                               rtol=1e-6)


def test_noise_is_drawn_only_when_asked(rng):
    raw, z, d, _ = _volume_inputs(rng)
    g = torch.Generator().manual_seed(0)
    a = volume.raw2outputs(_t(raw), _t(z), _t(d), 0.0, generator=g)
    state = g.get_state()
    b = volume.raw2outputs(_t(raw), _t(z), _t(d), 0.0, generator=g)
    assert torch.equal(g.get_state(), state) and torch.equal(a.rgb, b.rgb)
    volume.raw2outputs(_t(raw), _t(z), _t(d), 1.0, generator=g)
    assert not torch.equal(g.get_state(), state)


def test_ndc_and_origin_translations(rng):
    o = rng.normal(size=(20, 3)).astype(np.float32)
    d = rng.normal(size=(20, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    for near in (1.0, 1.5):
        for got, want in zip(rays.ndc_rays(8, 9, 7.0, near, _t(o), _t(d)),
                             jrays.ndc_rays(8, 9, 7.0, near, jnp.asarray(o),
                                            jnp.asarray(d))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for mode in ("", "fixed", "2.5", "to_sphere", "adaptive", "adapative"):
        want = np.asarray(jrays.apply_trans_origin(jnp.asarray(o), jnp.asarray(d), mode))
        got = rays.apply_trans_origin(_t(o), _t(d), mode).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=mode)
    np.testing.assert_allclose(
        rays.translate_origin_to_sphere(_t(o), _t(d), 2.0).numpy(),
        np.asarray(jrays.translate_origin_to_sphere(jnp.asarray(o), jnp.asarray(d), 2.0)),
        atol=1e-6, rtol=0)


def test_get_rays_divided_focal_scale(rng):
    """A numpy f32 scale takes the JAX package's traced-scale branch: x and y
    divided by the scale, bit for bit with JAX's get_rays op by op; under jit
    XLA contracts the rotation into FMAs and may land one ulp away."""
    import jax

    c2w = jposes.pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    for _ in range(3):
        fs = np.float32(1.0 + rng.random())
        jo, jd = jrays.get_rays(8, 8, 9.0, jnp.asarray(c2w), focal_scale=jnp.float32(fs))
        o, d = rays.get_rays(8, 8, 9.0, c2w, focal_scale=fs, device="cpu")
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        _, jd = jax.jit(lambda c, s: jrays.get_rays(8, 8, 9.0, c, focal_scale=s))(
            jnp.asarray(c2w), jnp.float32(fs))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=4e-7, rtol=0)
    # a Python scale multiplies the focal, as the JAX package's first branch
    jo, jd = jrays.get_rays(8, 8, 9.0, jnp.asarray(c2w), focal_scale=1.5)
    o, d = rays.get_rays(8, 8, 9.0, c2w, focal_scale=1.5, device="cpu")
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_pose_samplers_match_jax():
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        np.testing.assert_array_equal(poses.random_spherical_pose(r1, radius=3.5),
                                      jposes.random_spherical_pose(r2, radius=3.5))
    capture = np.stack([jposes.pose_spherical(t, -20.0, 4.0)[:3, :4]
                        for t in (0.0, 10.0, 25.0, 30.0)])
    s1 = poses.make_llff_pose_sampler(capture)
    s2 = jposes.make_llff_pose_sampler(capture)
    for _ in range(4):
        p = s1(r1)
        assert p.shape == (3, 5) and p.dtype == np.float32
        np.testing.assert_array_equal(p, s2(r2))
    np.testing.assert_array_equal(poses.poses_avg(np.concatenate(
        [capture, np.zeros((4, 3, 1), np.float32)], -1)), jposes.poses_avg(
        np.concatenate([capture, np.zeros((4, 3, 1), np.float32)], -1)))
