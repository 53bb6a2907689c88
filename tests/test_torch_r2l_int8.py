"""The W8A8 R2L forward: packing and calibration against the JAX package's,
the plain version (what the wrapper runs on CPU tensors) against the JAX
Pallas kernel in interpret mode, the wrapper's checks, and the CUDA kernel
against the plain version on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.ops.pallas import r2l_int8 as jint8
from efficient_nerf_tpu_torch.models import R2LNet
from efficient_nerf_tpu_torch.ops import r2l_int8 as i8
from efficient_nerf_tpu_torch.ops.r2l_forward import _doubling_head_perm_np

N_SAMPLE, L, DEPTH = 16, 10, 10          # 4 residual blocks
IN_DIM = 3 * N_SAMPLE * (2 * L + 1)      # 1008, padded to 1024
NEAR, FAR = 2.0, 6.0
B = 32                                   # the JAX package's own int8 tests'
# The JAX package's own tolerances for its kernel against its jnp twin
# (tests/test_ops.py:230, :259): a one-ulp difference before a quantizer can
# move an activation by one int8 level, ~6e-3 of rgb after dequantization.
# Here the two packages' fast trig (up to 1e-5 apart, tests/test_torch_trig.py)
# and the head's summation order supply those ulps.
TOL = {"static": 1e-2, "dynamic": 1.5e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _setup(width, use_residual, rng, n=B):
    """The JAX package's int8 tests' model (its flax init, key 0) and rays
    (normal, from the seeded rng), and the port's R2LNet with its weights."""
    # flax is imported here, not at the top, so that the card tests below
    # also collect on a GPU host that has jax but not flax
    from efficient_nerf_tpu.models import R2LNet as JaxR2LNet

    jm = JaxR2LNet(input_dim=IN_DIM, depth=DEPTH, width=width,
                   use_residual=use_residual)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IN_DIM)))["params"]
    params = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), p)
    tm = R2LNet(IN_DIM, DEPTH, width, use_residual=use_residual
                ).load_jax_params(params)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return params, tm, o, d


@pytest.mark.parametrize("width", [32, 64])
def test_pack_matches_jax_bit_for_bit(width, rng):
    params, tm, _, _ = _setup(width, False, rng)
    want = jint8.pack_r2l_weights_int8(params)
    packed = i8.pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L)
    nb = (DEPTH - 2) // 2
    assert packed["body_qw"].shape == (nb, 2, width, width)
    assert packed["body_qw"].dtype == torch.int8
    # row n of the port's [out, in] weight is column n of JAX's [in, out]
    np.testing.assert_array_equal(packed["body_qw"].numpy(),
                                  np.swapaxes(np.asarray(want["body_qw"]), -1, -2))
    np.testing.assert_array_equal(packed["body_sw"].numpy(), np.asarray(want["body_sw"]))
    np.testing.assert_array_equal(packed["body_b"].numpy(), np.asarray(want["body_b"]))
    # the bf16 head (permuted, padded) and tail of the bf16 pack
    perm = _doubling_head_perm_np(N_SAMPLE, L)
    np.testing.assert_array_equal(
        packed["head_w"][:, :IN_DIM].float().numpy(),
        np.asarray(want["head_w"][perm].T.astype(jnp.float32)))
    assert torch.all(packed["head_w"][:, IN_DIM:] == 0)
    np.testing.assert_array_equal(
        packed["tail_w"].float().numpy(),
        np.asarray(want["tail_w"][:, :want["out_dim"]].T.astype(jnp.float32)))
    ops8, ops16 = i8.r2l_int8_ops(packed, 10)
    assert ops8 == 2 * 10 * 2 * nb * width * width
    assert ops16 == 2 * 10 * (IN_DIM * width + width * 3)


def test_quantizer_rounds_half_to_even_and_clips():
    w = torch.tensor([[127.0, 63.5, -0.5, 1.5, 2.5, -127.0]])
    q, s = i8._quantize_rows(w)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 64, 0, 2, 2, -127]]
    levels, scale = i8._qdyn(torch.tensor([[0.0, 0.0]]))   # an all-zero row
    assert levels.tolist() == [[0.0, 0.0]] and scale.item() > 0


@pytest.mark.parametrize("use_residual", [False, True])
def test_calibrate_matches_jax(use_residual, rng):
    params, tm, o, d = _setup(64, use_residual, rng, n=256)
    want = np.asarray(jint8.calibrate_r2l_int8(
        params, jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L))
    got = i8.calibrate_r2l_int8(tm.state_dict(), torch.from_numpy(o),
                                torch.from_numpy(d), NEAR, FAR, N_SAMPLE, L)
    assert got.shape == ((DEPTH - 2) // 2, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _jax_scales(params, o, d, mode):
    return (jint8.calibrate_r2l_int8(params, jnp.asarray(o), jnp.asarray(d), NEAR, FAR,
                                     N_SAMPLE, L) if mode == "static" else None)


def _port(packed, o, d, use_residual, scales):
    return i8.r2l_forward_int8(
        packed, torch.from_numpy(o), torch.from_numpy(d), NEAR, FAR, N_SAMPLE, L,
        use_global_residual=use_residual,
        act_scales=None if scales is None else torch.from_numpy(np.array(scales))).numpy()


WIDTHS = [(32, False), (64, False), (64, True)]


@pytest.mark.parametrize("width,use_residual", WIDTHS)
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_plain_version_matches_pallas_interpret(mode, width, use_residual, rng):
    # f32 head and tail on both sides, as the JAX package's own kernel tests
    # run (tests/test_ops.py:227, :247), both fed JAX's calibration
    params, tm, o, d = _setup(width, use_residual, rng)
    scales = _jax_scales(params, o, d, mode)
    want = np.asarray(jint8.r2l_forward_int8(
        params, jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L, tile_b=B,
        head_dtype=jnp.float32, use_global_residual=use_residual, act_scales=scales,
        interpret=True))
    packed = i8.pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L,
                                      head_dtype=torch.float32)
    launches = i8.r2l_forward_int8.launches
    got = _port(packed, o, d, use_residual, scales)
    assert i8.r2l_forward_int8.launches == launches   # CPU: no kernel launch
    assert got.shape == (B, 3) and np.isfinite(got).all()
    err = np.abs(got - want)
    # measured: max 3.4e-3 static (a level flip; 2e-5 at W64), 1.1e-2
    # dynamic; mean at most 7.3e-5 static, 3.0e-4 dynamic
    assert err.max() <= TOL[mode], err.max()
    assert err.mean() <= 1e-3, err.mean()


@pytest.mark.parametrize("width,use_residual", WIDTHS)
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_bf16_head_matches_jax(mode, width, use_residual, rng):
    """The kernel's bf16 head and tail: the plain version against the JAX
    twin with the same bf16 head, and against the Pallas kernel in interpret
    mode. The Pallas kernel differs from its own twin here by up to 2.2e-2:
    its head sums in another order, and where that moves a value across a
    quantizer's rounding boundary an activation moves by one int8 level."""
    params, tm, o, d = _setup(width, use_residual, rng)
    scales = _jax_scales(params, o, d, mode)
    twin = np.asarray(jint8.r2l_forward_int8_ref(
        params, jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L,
        use_global_residual=use_residual, act_scales=scales, head_dtype=jnp.bfloat16))
    kern = np.asarray(jint8.r2l_forward_int8(
        params, jnp.asarray(o), jnp.asarray(d), NEAR, FAR, N_SAMPLE, L, tile_b=B,
        use_global_residual=use_residual, act_scales=scales, interpret=True))
    got = _port(i8.pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L), o, d,
                use_residual, scales)
    # measured against the twin: at most 1.2e-7, and 7.7e-4 where a sum
    # landed an ulp apart (static, W64, use_residual)
    assert np.abs(got - twin).max() <= TOL[mode]
    # against the Pallas kernel: measured max 2.2e-2, mean at most 8.4e-4;
    # the port is as near to it as the JAX package's own twin is
    err = np.abs(got - kern)
    assert err.mean() <= 2e-3, err.mean()
    assert err.max() <= np.abs(twin - kern).max() + TOL[mode] / 2


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_plain_version_tracks_the_bf16_forward(mode, rng):
    # the int8 body stays close to the bf16 plain version of the same model;
    # the JAX package bounds its int8 forward against f32 by 0.12 max and
    # 0.012 mean on random weights (tests/test_ops.py:281); measured here at
    # most 2.4e-2 max and 5e-3 mean
    params, tm, o, d = _setup(64, False, rng)
    from efficient_nerf_tpu_torch.ops import r2l_forward as fwd

    ro, rd = torch.from_numpy(o), torch.from_numpy(d)
    bf16 = fwd.r2l_forward_fused_ref(fwd.pack_r2l_weights(tm.state_dict(), N_SAMPLE, L),
                                     ro, rd, NEAR, FAR, N_SAMPLE, L)
    packed = i8.pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L)
    scales = (i8.calibrate_r2l_int8(tm.state_dict(), ro, rd, NEAR, FAR, N_SAMPLE, L)
              if mode == "static" else None)
    got = i8.r2l_forward_int8(packed, ro, rd, NEAR, FAR, N_SAMPLE, L, act_scales=scales)
    err = (got - bf16).abs()
    assert err.max() < 0.05 and err.mean() < 0.01, (err.max(), err.mean())


@pytest.mark.parametrize("n", [37, 0])
def test_ragged_and_empty_batches(n, rng):
    params, tm, o, d = _setup(32, False, rng, n=max(n, 1))
    o, d = o[:n], d[:n]
    packed = i8.pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L)
    scales = torch.full(((DEPTH - 2) // 2, 2), 0.05)
    for act in (scales, None):
        got = i8.r2l_forward_int8(packed, torch.from_numpy(o), torch.from_numpy(d),
                                  NEAR, FAR, N_SAMPLE, L, act_scales=act)
        assert got.shape == (n, 3) and torch.isfinite(got).all()
        if n:
            # each ray is computed on its own: the rows of a longer batch
            # agree but for the head's summation order
            more = i8.r2l_forward_int8(
                packed, torch.from_numpy(np.concatenate([o, o, o])),
                torch.from_numpy(np.concatenate([d, d, d])), NEAR, FAR, N_SAMPLE, L,
                act_scales=act)
            assert (more[n:2 * n] - got).abs().max() <= TOL["dynamic"]


def test_bad_operands_raise(rng):
    _, tm, o, d = _setup(32, False, rng)
    packed = i8.pack_r2l_weights_int8(tm.state_dict(), N_SAMPLE, L)
    ro, rd = torch.from_numpy(o), torch.from_numpy(d)
    nb = (DEPTH - 2) // 2

    def run(p=packed, o_=ro, d_=rd, act=None, n_sample=N_SAMPLE):
        return i8.r2l_forward_int8(p, o_, d_, NEAR, FAR, n_sample, L, act_scales=act)

    with pytest.raises(ValueError, match="rays_o"):
        run(o_=ro.double())
    with pytest.raises(ValueError, match="rays_d"):
        run(d_=torch.zeros(B, 4))
    with pytest.raises(ValueError, match="differ in B"):
        run(d_=rd[:-1].contiguous())
    with pytest.raises(ValueError, match="act_scales"):
        run(act=torch.ones(nb, 3))
    with pytest.raises(ValueError, match="act_scales"):
        run(act=torch.ones(nb, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="body_qw"):
        run(p={**packed, "body_qw": packed["body_qw"].float()})
    with pytest.raises(ValueError, match="width"):
        run(p={**packed, "body_sw": packed["body_sw"][:, :, :-1].contiguous()})
    with pytest.raises(ValueError, match="packed for"):
        run(n_sample=N_SAMPLE - 1)
    with pytest.raises(ValueError, match="sigmoid-tail"):
        i8.pack_r2l_weights_int8(R2LNet(IN_DIM, DEPTH, 32, linear_tail=True).state_dict(),
                                 N_SAMPLE, L)


def _card_model(width, depth, rng):
    # lecun-normal kernels with each block's second linear times 0.1, small
    # biases: the outputs stay clear of the sigmoid's flat ends (the init of
    # perfbench/configs/r2l_w256d88.json)
    tm = R2LNet(IN_DIM, depth, width)
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            if ".body.2.weight" in name:
                scale *= 0.1
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    return tm


def _frame_rays(n, dev, rng):
    """n rays drawn from three frames of the benchmark's served orbit
    (perfbench/traffic/serve_orbit.json), the rays the flagship serves."""
    import json
    from pathlib import Path

    from efficient_nerf_tpu_torch.core.rays import get_rays
    from perfbench import inputs

    serve = json.loads((Path(__file__).resolve().parents[1] / "perfbench" / "traffic"
                        / "serve_orbit.json").read_text())
    H, W = serve["H"], serve["W"]
    rays = [get_rays(H, W, inputs.focal_of(serve),
                     inputs.pose_spherical(t, serve["phi"], serve["radius"])[:3, :4],
                     device=dev)
            for t in (-150.0, -30.0, 90.0)]
    pick = torch.from_numpy(rng.integers(0, 3 * H * W, n)).to(dev)
    return tuple(torch.cat([r[i].reshape(-1, 3) for r in rays])[pick].contiguous()
                 for i in (0, 1))


# depth 12 on random rays, and the flagship's 88 on the rays it serves: the
# static scales follow the rays' range, and on random rays at D88 one level
# more than the noise below allows has been measured (1.07e-2, PERF.md)
@pytest.mark.cuda
@pytest.mark.parametrize("depth,frame", [(12, False), (88, True)])
@pytest.mark.parametrize("width", [256, 96])      # 96: TMA's zeros past column 96
@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("n", [200, 37, 8192])    # 4 tiles, the last ragged; one; 128
def test_kernel_matches_plain_version(n, mode, width, depth, frame, cuda_device, rng):
    tm = _card_model(width, depth, rng)
    sd = {k: v.to(cuda_device) for k, v in tm.state_dict().items()}
    packed = i8.pack_r2l_weights_int8(sd, N_SAMPLE, L)
    if frame:
        ro, rd = _frame_rays(n, cuda_device, rng)
    else:
        ro = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda_device)
        rd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda_device)
    act = (i8.calibrate_r2l_int8(sd, ro, rd, NEAR, FAR, N_SAMPLE, L)
           if mode == "static" else None)
    # rows past B: their rays embed as zeros, and in the dynamic mode their
    # row maxima stay in their own rows
    again = i8.r2l_forward_int8(packed, ro, rd, NEAR, FAR, N_SAMPLE, L, act_scales=act)
    assert torch.equal(again, i8.r2l_forward_int8(packed, ro, rd, NEAR, FAR, N_SAMPLE, L,
                                                  act_scales=act))
    for use_res in (False, True):
        launches = i8.r2l_forward_int8.launches
        got = i8.r2l_forward_int8(packed, ro, rd, NEAR, FAR, N_SAMPLE, L,
                                  use_global_residual=use_res, act_scales=act)
        torch.cuda.synchronize()
        assert i8.r2l_forward_int8.launches == launches + 1
        want = i8.r2l_forward_int8_ref(packed, ro, rd, NEAR, FAR, N_SAMPLE, L,
                                       use_global_residual=use_res, act_scales=act)
        # the same int8 products (exact) and f32 epilogues; only the bf16
        # head's and tail's summation order differs, which can move an
        # activation by one int8 level: chip_smoke.py's INT8_TOL, set from
        # that noise measured at 88 layers (PERF.md)
        torch.testing.assert_close(got, want, atol=8e-3, rtol=0)
    empty = torch.zeros((0, 3), device=cuda_device)
    assert i8.r2l_forward_int8(packed, empty, empty, NEAR, FAR, N_SAMPLE, L,
                               act_scales=act).shape == (0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_kernel_runs_wide_inputs_in_parts(mode, cuda_device, rng):
    """An input of 1536 columns (n_sample 24), whose embed the tile writes and
    contracts in parts before the int8 body."""
    n_sample = 24
    tm = R2LNet(3 * n_sample * (2 * L + 1), 8, 256)
    with torch.no_grad():
        for name, v in tm.named_parameters():
            scale = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            if ".body.2.weight" in name:
                scale *= 0.1
            v.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(v.shape)).astype(np.float32)))
    sd = {k: v.to(cuda_device) for k, v in tm.state_dict().items()}
    packed = i8.pack_r2l_weights_int8(sd, n_sample, L)
    assert packed["head_w"].shape[1] == 1536
    ro = torch.from_numpy(rng.normal(size=(130, 3)).astype(np.float32)).to(cuda_device)
    rd = torch.from_numpy(rng.normal(size=(130, 3)).astype(np.float32)).to(cuda_device)
    act = (i8.calibrate_r2l_int8(sd, ro, rd, NEAR, FAR, n_sample, L)
           if mode == "static" else None)
    got = i8.r2l_forward_int8(packed, ro, rd, NEAR, FAR, n_sample, L, act_scales=act)
    want = i8.r2l_forward_int8_ref(packed, ro, rd, NEAR, FAR, n_sample, L, act_scales=act)
    torch.testing.assert_close(got, want, atol=8e-3, rtol=0)
