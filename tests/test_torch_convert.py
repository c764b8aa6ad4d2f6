"""The numpy converter between the JAX NSF and the port, the port's import
boundary, and ``chip_smoke.py`` on a host without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.train.loop import _path_str

from gpzoo_tpu_torch.convert import NSF_PATHS, nsf_from_numpy, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params():
    x = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (60, 2)))
    model = gz.SlideseqNSFConfig(D=5, N=60, L=3, M=8, batch_size=16).build(
        jax.random.PRNGKey(1), x)
    return model, {_path_str(p): np.asarray(v)
                   for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def test_jax_paths_are_the_ports_parameter_names():
    _, params = _jax_params()
    assert set(params) == set(NSF_PATHS)
    port = nsf_from_numpy(params, "cpu", torch.float64)
    assert {n for n, _ in port.named_parameters()} == set(NSF_PATHS)


def test_round_trip_is_exact():
    model, params = _jax_params()
    port = nsf_from_numpy(params, "cpu", torch.float64,
                          jitter=model.prior.jitter)
    back = to_numpy(port)
    for path in NSF_PATHS:
        assert back[path].dtype == np.float64
        np.testing.assert_array_equal(back[path], params[path])
    assert port.prior.jitter == model.prior.jitter
    assert port.prior.var_floor == model.prior.var_floor


def test_missing_leaf_raises():
    _, params = _jax_params()
    del params["prior.Lu_raw"]
    with pytest.raises(KeyError):
        nsf_from_numpy(params, "cpu", torch.float64)


def _run(code_or_args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = ("import sys, importlib, pkgutil, gpzoo_tpu_torch\n"
            "for m in pkgutil.walk_packages(gpzoo_tpu_torch.__path__, "
            "'gpzoo_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'gpzoo_tpu')]\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(["-c", code], REPO)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_gpu():
    res = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
