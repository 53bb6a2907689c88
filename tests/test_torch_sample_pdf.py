"""The deterministic inverse-CDF sampler: its plain version (what the wrapper
runs on CPU tensors) against the Pallas kernel in interpret mode and the
JAX package's core sample_pdf; the CUDA kernel against the plain version on
a card, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.core.sampling import sample_pdf as jax_sample_pdf
from efficient_nerf_tpu.ops.pallas.sample_pdf import sample_pdf_det_fused as jax_fused
from efficient_nerf_tpu_torch.ops import sample_pdf as sp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _inputs(rng, N=37, C=63):
    """Sorted bins in [2, 6] and uniform weights, with the degenerate rows of
    tests/test_ops.py:103-129: all-zero weights and a single spike; and a
    row whose CDF total rounds above 1."""
    bins = np.sort(rng.uniform(2.0, 6.0, size=(N, C)).astype(np.float32), -1)
    w = rng.uniform(size=(N, C - 1)).astype(np.float32)
    w[0] = 0.0
    w[1] = 0.0
    w[1, 5] = 100.0
    w[2] = np.float32(1.0 / 3.0)
    return bins, w


def _cdf_total_above_one(w):
    """Rows whose sequential CDF total, as the kernels accumulate it, ends
    above 1."""
    w = w + np.float32(1e-5)
    total = np.zeros(w.shape[0], np.float32)
    for i in range(w.shape[1]):
        total = total + w[:, i]
    cdf = np.zeros(w.shape[0], np.float32)
    for i in range(w.shape[1]):
        cdf = cdf + w[:, i] / total
    return cdf > 1


@pytest.mark.parametrize("n", [128, 17])
def test_plain_version_matches_pallas_interpret(n, rng):
    bins, w = _inputs(rng)
    assert _cdf_total_above_one(w).any()
    want = np.asarray(jax_fused(jnp.asarray(bins), jnp.asarray(w), n,
                                tile_n=16, interpret=True))
    launches = sp.sample_pdf_det_fused.launches
    got = sp.sample_pdf_det_fused(torch.from_numpy(bins), torch.from_numpy(w),
                                  n).numpy()
    assert sp.sample_pdf_det_fused.launches == launches  # CPU: no launch
    assert got.shape == (37, n)
    # below the top level the two differ only by the order of the weight
    # total's sum (sequential here, XLA's reduction there), ~1e-7 in the
    # CDF and up to ~1e-5 in z (the JAX package's own tolerance for the
    # kernel against core, tests/test_ops.py:120); the top level is pinned
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], atol=5e-5)
    np.testing.assert_array_equal(got[:, -1], bins[:, -1])
    np.testing.assert_array_equal(want[:, -1], bins[:, -1])
    assert np.all(np.diff(got, axis=-1) >= 0)


def test_plain_version_matches_core_below_top(rng):
    bins, w = _inputs(rng)
    want = np.asarray(jax_sample_pdf(None, jnp.asarray(bins), jnp.asarray(w),
                                     128, det=True))
    got = sp.sample_pdf_det_fused_ref(torch.from_numpy(bins),
                                      torch.from_numpy(w), 128).numpy()
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], atol=5e-5)


def test_checks_and_empty(rng):
    bins, w = _inputs(rng)
    with pytest.raises(ValueError, match="C-1"):
        sp.sample_pdf_det_fused(torch.from_numpy(bins), torch.from_numpy(bins), 8)
    out = sp.sample_pdf_det_fused(torch.zeros(0, 5), torch.zeros(0, 4), 8)
    assert out.shape == (0, 8)


# (N, n, C): a ragged block of rays, many blocks, few levels, a 32,768-ray
# chunk of the lego config's fine pass (more warps than are resident: the
# blocks stride over the rays), and another coarse count
@pytest.mark.cuda
@pytest.mark.parametrize("N,n,C", [(37, 128, 63), (4099, 128, 63), (300, 17, 63),
                                   (32768, 128, 63), (300, 64, 17)])
def test_kernel_matches_plain_version_bitwise(N, n, C, cuda_device, rng):
    bins, w = _inputs(rng, N, C)
    tb = torch.from_numpy(bins).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device)
    launches = sp.sample_pdf_det_fused.launches
    got = sp.sample_pdf_det_fused(tb, tw, n)
    torch.cuda.synchronize()
    assert sp.sample_pdf_det_fused.launches == launches + 1
    want = sp.sample_pdf_det_fused_ref(tb, tw, n)
    # every operation rounds alike on both sides (csrc/sample_pdf.cu)
    assert torch.equal(got, want), (got - want).abs().max().item()
