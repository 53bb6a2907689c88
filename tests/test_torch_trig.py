"""The port's fast polynomial trig against the JAX package's, and the port's
independence from JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_nerf_tpu.ops.pallas import trig as jtrig
from efficient_nerf_tpu_torch.ops import trig

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "efficient_nerf_tpu_torch"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: README, port section)")
    return torch.device("cuda")


def _inputs(rng):
    # |y| <= 4e3 covers the double-angle embeds' base angles and the
    # teacher's 2^9-scaled encodings
    y = rng.uniform(-4e3, 4e3, size=20000).astype(np.float32)
    return np.concatenate([y, np.float32([0.0, np.pi / 2, -np.pi, 1e-3])])


# Both versions evaluate the same f32 operations in the same order, so they
# agree to rounding; 1e-5 leaves room for XLA fusing a multiply-add on CPU.
TOL = 1e-5


@pytest.mark.parametrize("degree", [7, 9])
@pytest.mark.parametrize("fn", ["fast_sin", "fast_cos"])
def test_fast_sin_cos_match_jax(fn, degree, rng):
    y = _inputs(rng)
    got = getattr(trig, fn)(torch.from_numpy(y), degree).numpy()
    want = np.asarray(getattr(jtrig, fn)(jnp.asarray(y), degree))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("degree", [7, 9])
def test_fast_sincos_matches_jax(degree, rng):
    y = _inputs(rng)
    s, c = trig.fast_sincos(torch.from_numpy(y), degree)
    js, jc = jtrig.fast_sincos(jnp.asarray(y), degree)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL, rtol=0)


def test_fast_sincos_cuda_on_cpu_tensor_is_plain_version(rng):
    y = torch.from_numpy(_inputs(rng))
    for got, want in zip(trig.fast_sincos_cuda(y), trig.fast_sincos(y)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fast_sincos_kernel_matches_plain(cuda_device, rng):
    y = torch.from_numpy(_inputs(rng)).to(cuda_device)
    for degree in (7, 9):
        got = trig.fast_sincos_cuda(y, degree)
        want = trig.fast_sincos(y, degree)
        # trig.cuh rounds each operation as the plain version does
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1.2e-7, rtol=0)


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax and the JAX package
    made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'efficient_nerf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import efficient_nerf_tpu_torch as p\n"
        "for info in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "chip_breakdown.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "efficient_nerf_tpu"), \
                f"{f.relative_to(ROOT)} imports {mod}"
