"""The whole-ray teacher render: the plain version of the frame kernel (what
the wrapper runs on CPU tensors) against the Pallas frame kernel in
interpret mode and against the JAX render_rays eval path; the CUDA kernel
against the plain version, and its fine depths against the sampler kernel,
on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.models import NeRFMLP
from efficient_nerf_tpu_torch.ops import nerf_forward as nf
from efficient_nerf_tpu_torch.ops import nerf_frame as fr
from efficient_nerf_tpu_torch.ops import sample_pdf as sp

# the JAX package's own test of its frame kernel (tests/test_ops.py:342)
L, LV, N, SC, SF = 4, 2, 13, 16, 32
# f32 on both sides, the same constants and composite math: measured within
# 1e-6 of the Pallas kernel (its points are o F + z d F, not (o + z d) F,
# and its transmittance a parallel scan) and within 1e-5 of render_rays,
# but for z_std under lindisp: render_rays samples at XLA's linspace depths
# where both frame kernels take numpy's, an ulp apart, and its fine depths
# move by up to 2.7e-5 (the Pallas kernel shows the same against it)
ATOL = 2e-5
ATOL_LINDISP_Z_STD = 5e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _models(seed=0, width=32):
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=4, width=width, skips=(1,), input_ch=3 * (2 * L + 1),
                    input_ch_views=3 * (2 * LV + 1), dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 3 * (2 * L + 1) + 3 * (2 * LV + 1))))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = NeRFMLP(depth=4, width=width, skips=(1,), input_ch=3 * (2 * L + 1),
                 input_ch_views=3 * (2 * LV + 1)).load_jax_params(params)
    return jm, params, tm


def _rays(rng):
    o = rng.normal(size=(N, 3)).astype(np.float32)
    d = (rng.normal(size=(N, 3)) * 0.3 + np.array([0, 0, -1.0])).astype(np.float32)
    return o, d, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _assert_close(got, want, atol, names):
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), b.numpy()
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b)), name
        np.testing.assert_allclose(np.where(nan, 0, b), np.where(nan, 0, a),
                                   atol=atol.get(name, ATOL), err_msg=name)


@pytest.mark.parametrize("lindisp", [False, True])
def test_plain_version_matches_pallas_and_render_rays(lindisp, rng):
    from efficient_nerf_tpu.ops.pallas.nerf_frame import nerf_render_rays_fused as jframe
    from efficient_nerf_tpu.render.renderer import RenderConfig, render_rays

    jm, params, tm = _models()
    o, d, vd = _rays(rng)
    jo, jd, jv = (jnp.asarray(a) for a in (o, d, vd))
    cfg = RenderConfig(n_samples=SC, n_importance=SF, perturb=False, white_bkgd=True,
                       multires=L, multires_views=LV, near=2.0, far=6.0,
                       fast_embed=False, fused_teacher=False, lindisp=lindisp)
    want_xla = render_rays(jm, params, None, jo, jd, jv, None, cfg)
    want_kern = jframe(params, None, jo, jd, jv, 2.0, 6.0, SC, SF, L, LV, skip=1,
                       white_bkgd=True, lindisp=lindisp, dtype=jnp.float32, tile_r=8,
                       interpret=True)
    packed = nf.pack_nerf_weights(tm.state_dict(), skip=1, dtype=torch.float32)
    launches = fr.nerf_render_rays_fused.launches
    got = fr.nerf_render_rays_fused(packed, None, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(vd), 2.0, 6.0, SC, SF, L, LV,
                                    white_bkgd=True, lindisp=lindisp)
    assert fr.nerf_render_rays_fused.launches == launches  # CPU: no kernel launch
    assert [tuple(x.shape) for x in got] == [(N, 3), (N,), (N,), (N,), (N, 3), (N,), (N,),
                                             (N,)]
    assert np.isnan(np.asarray(want_xla.disp)).any()   # empty rays: NaN disp on both
    _assert_close(got, want_kern, {}, want_xla._fields)
    _assert_close(got, want_xla, {"z_std": ATOL_LINDISP_Z_STD} if lindisp else {},
                  want_xla._fields)


def test_plain_version_with_a_fine_model_matches_pallas(rng):
    from efficient_nerf_tpu.ops.pallas.nerf_frame import nerf_render_rays_fused as jframe

    _, params, tm = _models(0)
    _, params_f, tm_f = _models(1)
    o, d, vd = _rays(rng)
    want = jframe(params, params_f, *(jnp.asarray(a) for a in (o, d, vd)), 2.0, 6.0, SC, SF,
                  L, LV, skip=1, white_bkgd=False, dtype=jnp.float32, tile_r=8,
                  interpret=True)
    pc, pf = (nf.pack_nerf_weights(m.state_dict(), skip=1, dtype=torch.float32)
              for m in (tm, tm_f))
    got = fr.nerf_render_rays_fused(pc, pf, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(vd), 2.0, 6.0, SC, SF, L, LV, taps=True)
    _assert_close(got[:8], want, {}, ("rgb", "disp", "acc", "depth", "rgb0", "disp0", "acc0",
                                      "z_std"))
    # the taps: the coarse weights and the fine depths the sampler draws from them
    w, zf = got[8:]
    assert w.shape == (N, SC) and zf.shape == (N, SF)
    _, bins, u = fr._consts(2.0, 6.0, SC, SF, False, torch.device("cpu"))
    torch.testing.assert_close(sp.sample_pdf_det_fused(bins.expand(N, SC - 1).contiguous(),
                                                       w[:, 1:-1].contiguous(), SF, levels=u),
                               zf, rtol=0, atol=0)


def test_mismatched_architectures_and_shapes_raise(rng):
    _, _, tm = _models()
    _, _, tm_wide = _models(width=64)
    pc = nf.pack_nerf_weights(tm.state_dict(), skip=1, dtype=torch.float32)
    pw = nf.pack_nerf_weights(tm_wide.state_dict(), skip=1, dtype=torch.float32)
    o, d, vd = (torch.from_numpy(a) for a in _rays(rng))
    with pytest.raises(ValueError, match="matching coarse/fine"):
        fr.nerf_render_rays_fused(pc, pw, o, d, vd, 2.0, 6.0, SC, SF, L, LV)
    with pytest.raises(ValueError, match="viewdirs"):
        fr.nerf_render_rays_fused(pc, None, o, d, vd[:3], 2.0, 6.0, SC, SF, L, LV)
    with pytest.raises(ValueError, match="columns"):
        fr.nerf_render_rays_fused(pc, None, o, d, vd, 2.0, 6.0, SC, SF, L + 1, LV)
    # the Pallas wrapper's constants: numpy f64 then f32
    z, bins, u = fr._np_consts(2.0, 6.0, 64, 128, False)
    assert z.dtype == bins.dtype == u.dtype == np.float32
    np.testing.assert_array_equal(z, np.float32(2.0 * (1 - np.linspace(0, 1, 64))
                                                + 6.0 * np.linspace(0, 1, 64)))
    assert fr._rays_per_block(64) == 4 and fr._rays_per_block(16) == 16


def _card_teacher(rng, width=256):
    """A random teacher with lecun-normal kernels and small biases (the
    init of perfbench/configs/nerf_lego.json)."""
    tm = NeRFMLP(depth=8, width=width)
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    return tm


# Per ray, each output against the plain version's (rgb, acc and disp in [0,
# 1]-ish, depth in [near, far]): a ray whose pass ends on a sigma within the
# field's bf16 noise of 0 turns opaque or clear as the sign flips (the last
# interval is 1e10 long), so one ray in 10,000 may lie beyond; none in a
# batch of fewer. Output index -> tolerance: rgb, acc, depth, and the coarse
# pass's rgb0, disp0, acc0.
FRAME_TOL = {0: 2e-2, 2: 2e-2, 3: 1e-1, 4: 2e-2, 5: 2e-2, 6: 2e-2}


# 37 and 1111 rays (odd: a ragged last group; 278 groups of 4, more than
# one a block), other coarse / fine sample counts (84 rays a group at 3
# coarse samples) and the renderer's chunk of the lego config (32,768 rays)
@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,width,S_c,S_f", [(37, 256, 64, 128), (20, 64, 16, 32),
                                                  (1111, 64, 64, 128), (13, 128, 3, 1),
                                                  (29, 256, 32, 96), (1, 128, 64, 128),
                                                  (32768, 256, 64, 128)])
def test_kernel_matches_plain_version(n_rays, width, S_c, S_f, cuda_device, rng):
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in
                                   _card_teacher(rng, width).state_dict().items()})
    o = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.3)
    o[:, 2] += 4.0
    d = torch.from_numpy((rng.normal(size=(n_rays, 3)) * 0.3 + [0, 0, -1]).astype(np.float32))
    o, d = o.to(cuda_device), d.to(cuda_device)
    vd = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    args = (packed, None, o, d, vd, 2.0, 6.0, S_c, S_f, 10, 4)
    launches = fr.nerf_render_rays_fused.launches
    got = fr.nerf_render_rays_fused(*args, white_bkgd=True, taps=True)
    torch.cuda.synchronize()
    assert fr.nerf_render_rays_fused.launches == launches + 1
    want = fr.nerf_render_rays_fused_ref(*args, white_bkgd=True, taps=True)
    # the field kernel's bf16 noise (tests/test_torch_nerf_forward.py)
    # through the composite. disp0 is 0/0 where the coarse pass has no
    # opacity: a NaN there agrees only where it is NaN on both sides and
    # acc0 is 0 on both sides; any other NaN fails
    clear = ((got[6] == 0) & (want[6] == 0)).reshape(n_rays, 1)
    beyond = torch.zeros(n_rays, dtype=torch.bool, device=cuda_device)
    for i, tol in FRAME_TOL.items():
        g, w = got[i].reshape(n_rays, -1), want[i].reshape(n_rays, -1)
        nan_ok = g.isnan() & w.isnan() & clear if i == 5 else torch.zeros_like(clear)
        assert not ((g.isnan() | w.isnan()) & ~nan_ok).any()
        beyond |= ~(((g - w).abs() <= tol) | nan_ok).all(-1)
    assert int(beyond.sum()) <= n_rays // 10_000
    # the fine depths are the sampler kernel's walk on the kernel's own weights,
    # bit for bit
    _, bins, u = fr._consts(2.0, 6.0, S_c, S_f, False, cuda_device)
    zf = sp.sample_pdf_det_fused(bins.expand(n_rays, S_c - 1).contiguous(),
                                 got[8][:, 1:-1].contiguous(), S_f, levels=u)
    assert torch.equal(zf, got[9])


@pytest.mark.cuda
def test_kernel_two_calls_same_bits(cuda_device, rng):
    packed = nf.pack_nerf_weights({k: v.to(cuda_device) for k, v in
                                   _card_teacher(rng).state_dict().items()})
    o = torch.from_numpy(rng.normal(size=(41, 3)).astype(np.float32) * 0.3)
    o[:, 2] += 4.0
    d = torch.from_numpy((rng.normal(size=(41, 3)) * 0.3 + [0, 0, -1]).astype(np.float32))
    o, d = o.to(cuda_device), d.to(cuda_device)
    vd = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    args = (packed, None, o, d, vd, 2.0, 6.0, 64, 128, 10, 4)
    first = fr.nerf_render_rays_fused(*args, white_bkgd=True, taps=True)
    again = fr.nerf_render_rays_fused(*args, white_bkgd=True, taps=True)
    for a, b in zip(first, again):
        assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0))
