"""The W8A8 teacher field eval: the int8 pack against the Pallas pack bit for
bit, the calibration, and the plain version of the int8 kernel (what the
wrapper runs on CPU tensors) against the Pallas kernel in interpret mode and
its jnp twin; the CUDA kernel against the plain version on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.ops.pallas import nerf_int8 as jni
from efficient_nerf_tpu_torch.models import NeRFMLP
from efficient_nerf_tpu_torch.ops import nerf_forward as nf
from efficient_nerf_tpu_torch.ops import nerf_int8 as ni

L, LV = 10, 4
# The plain version against the Pallas kernel in interpret mode and against
# its jnp twin, at the JAX package's own test shapes (W256 D8, N 9, S 24,
# tests/test_ops.py:377): the same quantization math and roundings, so they
# agree to 9e-8 (f32) and 6e-8 (bf16) as measured; a level that an ulp moves
# across a rounding boundary would cost up to a few 1e-3. The ceiling is the
# JAX package's own tolerance for its kernel against its twin.
TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _params(skip=4, depth=8, width=256):
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import NeRFMLP as JaxNeRFMLP

    jm = JaxNeRFMLP(depth=depth, width=width, skips=(skip,), dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 90)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = NeRFMLP(depth=depth, width=width, skips=(skip,)).load_jax_params(params)
    return params, tm


def _inputs(rng, N, S):
    pts = rng.normal(size=(N, S, 3)).astype(np.float32) * 1.5
    vd = rng.normal(size=(N, 3)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True)


@pytest.mark.parametrize("skip", [4, 6])   # 6 = depth - 2: the last layer takes the skip
def test_pack_matches_jax_bitwise(skip):
    params, tm = _params(skip)
    want = jni.pack_nerf_weights_int8(params, skip=skip)
    got = ni.pack_nerf_weights_int8(tm.state_dict(), skip=skip)
    assert got["body_qw"].dtype == got["feat_qw"].dtype == torch.int8
    # torch [out, in] against JAX [in, out]
    np.testing.assert_array_equal(got["body_qw"].transpose(1, 2).numpy(),
                                  np.asarray(want["body_qw"]))
    np.testing.assert_array_equal(got["body_sw"].numpy(), np.asarray(want["body_sw"]))
    np.testing.assert_array_equal(got["feat_qw"].t().numpy(), np.asarray(want["feat_qw"]))
    np.testing.assert_array_equal(got["feat_sw"].numpy(), np.asarray(want["feat_sw"]))
    for k in ("pts0_b", "views_b"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k]).astype(np.float32))
    np.testing.assert_array_equal(got["skip_x_w"][:, :63].t().float().numpy(),
                                  np.asarray(want["skip_x_w"]).astype(np.float32))
    np.testing.assert_array_equal(
        got["body_b_f32"].numpy(),
        np.stack([params[f"pts_{i}"]["bias"] for i in range(1, 8)]))
    np.testing.assert_array_equal(got["feat_b_f32"].numpy(), params["feature"]["bias"])
    assert "body_w" not in got and "feat_w" not in got and got["skip"] == skip


def test_calibration_matches_jax(rng):
    params, tm = _params()
    pts, _ = _inputs(rng, 9, 24)
    flat = pts.reshape(-1, 3)[:128]
    want = np.asarray(jni.calibrate_nerf_int8(params, jnp.asarray(flat), L, skip=4))
    got_sd = ni.calibrate_nerf_int8(tm.state_dict(), torch.from_numpy(flat), L, skip=4)
    packed = nf.pack_nerf_weights(tm.state_dict(), skip=4, dtype=torch.float32)
    got_pack = ni.calibrate_nerf_int8(packed, torch.from_numpy(flat), L)
    assert got_sd.shape == (8,) and torch.all(got_sd > 0)
    # f32 matmuls in another summation order: rtol 1e-5 (measured equal)
    np.testing.assert_allclose(got_sd.numpy(), want, rtol=1e-5)
    torch.testing.assert_close(got_pack, got_sd, rtol=0, atol=0)
    with pytest.raises(ValueError, match="f32"):
        ni.calibrate_nerf_int8(nf.pack_nerf_weights(tm.state_dict()), torch.from_numpy(flat), L)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("cm", [False, True])
def test_plain_version_matches_pallas_interpret(dtype, jdtype, cm, rng):
    params, tm = _params()
    pts, vd = _inputs(rng, 9, 24)
    scales = jni.calibrate_nerf_int8(params, jnp.asarray(pts).reshape(-1, 3)[:128], L, skip=4)
    jpts = jnp.moveaxis(jnp.asarray(pts), -1, 0) if cm else jnp.asarray(pts)
    kw = dict(act_scales=scales, dtype=jdtype, cm=cm)
    kern = np.asarray(jni.nerf_forward_int8(params, jpts, jnp.asarray(vd), interpret=True, **kw))
    twin = np.asarray(jni.nerf_forward_int8_ref(params, jpts, jnp.asarray(vd), **kw))
    packed = ni.pack_nerf_weights_int8(tm.state_dict(), skip=4, dtype=dtype)
    tp = torch.from_numpy(pts)
    launches = ni.nerf_forward_int8.launches
    got = ni.nerf_forward_int8(packed, tp.permute(2, 0, 1).contiguous() if cm else tp,
                               torch.from_numpy(vd), L, LV, cm=cm,
                               act_scales=torch.from_numpy(np.array(scales))).numpy()
    assert ni.nerf_forward_int8.launches == launches  # CPU: no kernel launch
    assert got.shape == ((4, 9, 24) if cm else (9, 24, 4))
    np.testing.assert_allclose(got, kern, atol=TOL)
    np.testing.assert_allclose(got, twin, atol=TOL)


def test_plain_version_with_the_skip_at_the_last_layer(rng):
    """skip = depth - 2: the unfolded last body layer adds the skip rows'
    product (:189-191)."""
    params, tm = _params(skip=6)
    pts, vd = _inputs(rng, 5, 16)
    scales = jni.calibrate_nerf_int8(params, jnp.asarray(pts).reshape(-1, 3), L, skip=6)
    want = np.asarray(jni.nerf_forward_int8_ref(params, jnp.asarray(pts), jnp.asarray(vd),
                                                skip=6, act_scales=scales))
    packed = ni.pack_nerf_weights_int8(tm.state_dict(), skip=6)
    got = ni.nerf_forward_int8_ref(packed, torch.from_numpy(pts), torch.from_numpy(vd), L, LV,
                                   act_scales=torch.from_numpy(np.array(scales))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_scales_and_operands_are_checked(rng):
    _, tm = _params()
    packed = ni.pack_nerf_weights_int8(tm.state_dict())
    pts, vd = (torch.from_numpy(a) for a in _inputs(rng, 2, 3))
    for fn in (ni.nerf_forward_int8, ni.nerf_forward_int8_ref):
        with pytest.raises(ValueError, match="act_scales"):
            fn(packed, pts, vd, L, LV, act_scales=None)
        with pytest.raises(ValueError, match="act_scales"):
            fn(packed, pts, vd, L, LV, act_scales=torch.ones(7))
    with pytest.raises(ValueError, match="viewdirs"):
        ni.nerf_forward_int8(packed, pts, vd[:1], L, LV, act_scales=torch.ones(8))
    with pytest.raises(ValueError, match="columns"):
        ni.nerf_forward_int8(packed, pts, vd, L - 1, LV, act_scales=torch.ones(8))
    # 2 operations a multiply-add: 8 int8 products of 256^2 a point, the bf16
    # layer 0 and skip rows, alpha head, view layer and rgb head, and the
    # per-ray direction rows
    i8, b16 = ni.nerf_int8_ops(packed, 10, 2)
    assert i8 == 2 * 10 * 8 * 256 * 256
    assert b16 == 2 * (10 * 65664 + 2 * 27 * 128)


def _card_teacher(rng, skip=4):
    """A random teacher with lecun-normal kernels and small biases (the
    init of perfbench/configs/nerf_lego.json)."""
    tm = NeRFMLP(depth=8, width=256, skips=(skip,))
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    return tm


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,cm,skip", [(20, 64, False, 4), (9, 192, False, 4),
                                         (37, 64, True, 4), (11, 24, False, 6),
                                         # a tile over 26 rays; 64 rays a warpgroup
                                         (61, 5, False, 6), (300, 1, False, 4),
                                         # 150 tiles: more than the resident blocks,
                                         # so each block's ring runs on across tiles
                                         (300, 64, False, 4),
                                         # the renderer's coarse and fine chunks
                                         (32768, 64, False, 4), (32768, 192, False, 4)])
def test_kernel_matches_plain_version(N, S, cm, skip, cuda_device, rng):
    tm = _card_teacher(rng, skip)
    sd = {k: v.to(cuda_device) for k, v in tm.state_dict().items()}
    packed = ni.pack_nerf_weights_int8(sd, skip=skip)
    pts, vd = _inputs(rng, N, S)
    tp = torch.from_numpy(pts).to(cuda_device)
    scales = ni.calibrate_nerf_int8(sd, tp.reshape(-1, 3)[:1024], L, skip=skip)
    if cm:
        tp = tp.permute(2, 0, 1).contiguous()
    tv = torch.from_numpy(vd).to(cuda_device)
    launches = ni.nerf_forward_int8.launches
    got = ni.nerf_forward_int8(packed, tp, tv, L, LV, act_scales=scales, cm=cm)
    torch.cuda.synchronize()
    assert ni.nerf_forward_int8.launches == launches + 1
    want = ni.nerf_forward_int8_ref(packed, tp, tv, L, LV, act_scales=scales, cm=cm)
    # the same levels but where a bf16 product's f32 sum lands an ulp apart
    # across a rounding boundary: relative to the largest magnitude; over a
    # chunk's millions of points a rarer crossing carries further (2.7e-2
    # measured on a fine chunk: chip_smoke.py's INT8_TEACHER_TOL there)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= (2e-2 if N * S < 1 << 20 else 6e-2), err
    # the tile's sums are taken in a fixed order: two calls give the same bits
    again = ni.nerf_forward_int8(packed, tp, tv, L, LV, act_scales=scales, cm=cm)
    assert torch.equal(got, again)
