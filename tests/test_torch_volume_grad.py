"""The compositing's transmittance takes a cumprod whose backward never reads
the device from the host (`core.volume._NonzeroCumprod`). Its forward values
and gradients equal those of torch.cumprod's autograd bit for bit on inputs
with no zero factor, which `1 - alpha + 1e-10` never holds in float32; the
exported `exclusive_cumprod` keeps torch's cumprod, zeros included. The
`cuda` cases hold the same on the card. No JAX import: the reference here
is the port's own path through torch.cumprod."""
import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.core import volume

N_RAYS, S = 1024, 192
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def _torch_cumprod_path(monkeypatch):
    """Route `_composite` through the exported op, torch.cumprod's autograd."""
    monkeypatch.setattr(volume, "_exclusive_cumprod_nonzero", volume.exclusive_cumprod)


def _inputs(dev, seed=0):
    """raw [N, S, 4], z_vals [N, S], rays_d [N, 3], noise [N, S]. Ray 0
    has every sigma clipped (each alpha exactly 0, acc 0); rays 1-7 hold
    sigmas so large that alpha is exactly 1 from some sample on; the rest mix
    clipped, small and large sigmas."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(N_RAYS, S, 4)).astype(np.float32)
    raw[..., 3] *= 3.0
    raw[0, :, 3] = -5.0
    raw[1:8, S // 3:, 3] = 1e4
    raw[8:64, ::7, 3] = 1e3
    z = np.sort(rng.uniform(2, 6, size=(N_RAYS, S)).astype(np.float32), -1)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    noise = rng.normal(size=(N_RAYS, S)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (raw, z, d, noise)]


def _alpha(raw, z, d, noise):
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(d[:, None, :], dim=-1)
    sigma = raw[..., 3] if noise is None else raw[..., 3] + noise
    return 1.0 - torch.exp(-torch.relu(sigma) * dists)


def _run(raw, z, d, noise, std, white, with_disp, cm=False):
    """Forward outputs and the gradients to raw, z_vals and rays_d of a
    fixed random cotangent on every output (disp too, NaN rays included,
    when with_disp)."""
    leaves = [t.clone().requires_grad_() for t in (raw, z, d)]
    r, zz, dd = leaves
    if cm:
        out = volume.raw2outputs_cm(r.movedim(-1, 0), zz, dd, std, white, noise=noise)
    else:
        out = volume.raw2outputs(r, zz, dd, std, white, noise=noise)
    gen = torch.Generator(raw.device).manual_seed(1)
    loss = 0.0
    for name, v in zip(out._fields, out):
        if name == "disp" and not with_disp:
            continue
        loss = loss + (v * torch.randn(v.shape, generator=gen, device=v.device)).sum()
    grads = torch.autograd.grad(loss, leaves)
    return [v.detach() for v in out] + list(grads)


def _assert_bits_equal(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), k


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("with_disp", [True, False])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("std", [0.0, 0.7])
def test_raw2outputs_bit_identical_to_torch_cumprod(std, white, with_disp, device,
                                                    monkeypatch):
    dev = _device(device)
    raw, z, d, noise = _inputs(dev)
    hook = noise if std > 0.0 else None     # the `noise` hook, as the tests' draws
    alpha = _alpha(raw, z, d, hook)
    assert (alpha == 1.0).any() and (alpha == 0.0).any()
    assert (alpha[1:8] == 1.0).any(-1).all() and (alpha[0] == 0.0).all()
    got = _run(raw, z, d, hook, std, white, with_disp)
    _torch_cumprod_path(monkeypatch)
    want = _run(raw, z, d, hook, std, white, with_disp)
    _assert_bits_equal(got, want)
    if not with_disp:   # the gradients are finite off disp's NaN rays
        assert all(torch.isfinite(g).all() for g in got[5:])


@pytest.mark.parametrize("cm", [False, True])
def test_raw2outputs_graph_holds_no_torch_cumprod_backward(cm, monkeypatch):
    raw, z, d, _ = _inputs(torch.device("cpu"))

    def node_names():
        r = raw[:8].clone().requires_grad_()
        rr = r.movedim(-1, 0) if cm else r
        out = (volume.raw2outputs_cm if cm else volume.raw2outputs)(rr, z[:8], d[:8])
        seen, todo, names = set(), [o.grad_fn for o in out], set()
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            names.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
        return names

    names = node_names()
    assert "CumprodBackward0" not in names
    assert "_NonzeroCumprodBackward" in names
    _torch_cumprod_path(monkeypatch)     # the walk does find torch's node
    assert "CumprodBackward0" in node_names()


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("dim", [-1, 0, 1])
def test_nonzero_cumprod_equals_torch_cumprod_bit_for_bit(dim, dtype, device):
    dev = _device(device)
    g = torch.Generator().manual_seed(2)
    x = (1.0 - torch.rand((33, 70, 5), generator=g) + 1e-10).to(dtype)
    x[3, 10:, :] = 1e-10                  # products that underflow to zero
    x[4, :, 2] = -0.5                     # signs
    x = x.to(dev)
    cot = torch.randn(x.shape, generator=g).to(dtype).to(dev)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    out_a = volume._NonzeroCumprod.apply(a, dim)
    out_b = torch.cumprod(b, dim)
    (out_a * cot).sum().backward()
    (out_b * cot).sum().backward()
    assert torch.equal(out_a, out_b)
    assert torch.equal(a.grad, b.grad)
    ex = volume._exclusive_cumprod_nonzero(x, dim)
    assert torch.equal(ex, volume.exclusive_cumprod(x, dim))


def test_exclusive_cumprod_keeps_torch_gradient_on_zeros():
    """The exported op stays correct for any input: with zeros its gradient
    is torch.cumprod's (finite), where the no-zero formula divides by 0."""
    x = torch.tensor([[0.5, 0.0, 2.0, 3.0, 0.25], [0.0, 0.0, 1.5, 2.0, 4.0],
                      [1.0, 2.0, 3.0, 4.0, 0.0]], dtype=torch.float64)
    cot = torch.arange(1.0, 16.0, dtype=torch.float64).reshape(3, 5)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (volume.exclusive_cumprod(a) * cot).sum().backward()
    cp = torch.cumprod(b, -1)
    ref = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], -1)
    (ref * cot).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert torch.isfinite(a.grad).all()
    # the product rule by hand: d/dx_k of sum_i c_i prod_{j<i} x_j
    want = torch.zeros_like(x)
    for r in range(3):
        for k in range(5):
            for i in range(k + 1, 5):
                p = torch.prod(torch.cat([x[r, :k], x[r, k + 1:i]]))
                want[r, k] += cot[r, i] * p
    torch.testing.assert_close(a.grad, want, rtol=1e-12, atol=0)
    c = x.clone().requires_grad_()
    (volume._exclusive_cumprod_nonzero(c) * cot).sum().backward()
    assert not torch.isfinite(c.grad).all()     # why _composite needs no zeros
