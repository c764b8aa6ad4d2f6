"""Carry an NSF model, over an SVGP or a VNNGP, between the JAX package
and the port as numpy arrays.

Leaves are keyed by the JAX package's dotted paths (``train/loop.py``
``_path_str``), which are also the port's ``named_parameters`` names:
``prior.kernel.sigma``, ``prior.kernel.lengthscale``, ``prior.Z``,
``prior.mu``, ``prior.Lu_raw``, ``W_raw`` and ``V_raw``. Flattening a JAX
model into such a dict is the caller's job; this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP
from gpzoo_tpu_torch.kernels.rbf import RBF
from gpzoo_tpu_torch.models.factorization import NSF

NSF_PATHS = ("prior.kernel.sigma", "prior.kernel.lengthscale", "prior.Z",
             "prior.mu", "prior.Lu_raw", "W_raw", "V_raw")


def _leaves(params, device, dtype):
    """Kernel and a tensor maker over the leaves of :data:`NSF_PATHS`."""
    missing = set(NSF_PATHS) - set(params)
    if missing:
        raise KeyError(f"missing NSF leaves: {sorted(missing)}")

    def t(path):
        return torch.tensor(np.asarray(params[path]), dtype=dtype, device=device)

    kernel = RBF(t("prior.kernel.sigma"), t("prior.kernel.lengthscale"),
                 input_dim=params["prior.Z"].shape[-1])
    return kernel, t


def nsf_from_numpy(params, device, dtype, jitter=1e-1, var_floor=1e-6):
    """The port's :class:`NSF` over an :class:`SVGP` holding copies of
    ``params`` (a dict of numpy arrays over :data:`NSF_PATHS`) on
    ``device`` as ``dtype``. ``jitter`` and ``var_floor`` are the SVGP's
    static fields, which the JAX model does not carry as leaves."""
    kernel, t = _leaves(params, device, dtype)
    gp = SVGP(kernel, t("prior.Z"), t("prior.mu"), t("prior.Lu_raw"),
              jitter=jitter, var_floor=var_floor)
    return NSF(gp, t("W_raw"), t("V_raw"))


def vnngp_from_numpy(params, device, dtype, K, jitter=1e-1, var_floor=5e-2):
    """The port's :class:`NSF` over a :class:`VNNGP` holding copies of
    ``params`` (the same leaf paths) on ``device`` as ``dtype``; K,
    ``jitter`` and ``var_floor`` are the VNNGP's static fields."""
    kernel, t = _leaves(params, device, dtype)
    gp = VNNGP(kernel, t("prior.Z"), t("prior.mu"), t("prior.Lu_raw"), K=K,
               jitter=jitter, var_floor=var_floor)
    return NSF(gp, t("W_raw"), t("V_raw"))


def to_numpy(model):
    """{dotted path: numpy array} of every parameter of ``model``."""
    return {path: p.detach().cpu().numpy()
            for path, p in model.named_parameters()}
