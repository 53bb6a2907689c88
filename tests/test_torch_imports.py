"""Import hygiene: every module of the port imports with JAX, flax, optax,
msgpack and the JAX package made unimportable."""
import os
import pkgutil
import subprocess
import sys

import efficient_nerf_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_port_module_imports_without_jax():
    names = sorted(m.name for m in pkgutil.walk_packages(
        efficient_nerf_tpu_torch.__path__, "efficient_nerf_tpu_torch."))
    for needed in ("main", "create_data", "factory", "evaluate", "config.options",
                   "config.gen_scene_configs", "train.checkpoints", "utils.logging",
                   "utils.meters", "utils.images", "utils.debug", "utils.profiling",
                   "utils.benchmark", "utils.visualize", "parallel", "parallel.mesh",
                   "parallel.tp", "parallel.train", "parallel.render",
                   "models.torch_import", "utils.msgpack", "metrics.lpips"):
        assert f"efficient_nerf_tpu_torch.{needed}" in names, needed
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'efficient_nerf_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'efficient_nerf_tpu') "
            "and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print(len(sys.argv), 'ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_an_entpuck1_file_reads_without_flax_or_msgpack(tmp_path):
    import jax.numpy as jnp

    from efficient_nerf_tpu.train.checkpoints import save_checkpoint

    path = save_checkpoint(str(tmp_path / "ckpt.msgpack"), {"w": jnp.arange(6.0).reshape(2, 3)},
                           step=4)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'efficient_nerf_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from efficient_nerf_tpu_torch.train import load_checkpoint\n"
            f"c = load_checkpoint({path!r})\n"
            "print(c['global_step'], c['params']['w'].sum(), c['opt_state'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["4", "15.0", "None"]
