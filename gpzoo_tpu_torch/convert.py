"""Carry an NSF model (over an SVGP or a VNNGP) or an MGGP-NSF model
between the JAX package and the port as numpy arrays.

Leaves are keyed by the JAX package's dotted paths (``train/loop.py``
``_path_str``), which are also the port's ``named_parameters`` and
``named_buffers`` names: ``prior.kernel.sigma``, ``prior.kernel.lengthscale``,
``prior.Z``, ``prior.mu``, ``prior.Lu_raw``, ``W_raw`` and ``V_raw`` for
NSF; :data:`MGGP_PATHS` for MGGP-NSF. Flattening a JAX model into such a
dict is the caller's job; this module imports no JAX.
"""

from __future__ import annotations

from itertools import chain

import numpy as np
import torch

from gpzoo_tpu_torch.gps.mggp import MGGPSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP
from gpzoo_tpu_torch.kernels.mggp import MGGPNSFRBF
from gpzoo_tpu_torch.kernels.rbf import RBF
from gpzoo_tpu_torch.models.factorization import MGGPNSF, NSF

NSF_PATHS = ("prior.kernel.sigma", "prior.kernel.lengthscale", "prior.Z",
             "prior.mu", "prior.Lu_raw", "W_raw", "V_raw")
MGGP_PATHS = ("gp.kernel.sigma", "gp.kernel.lengthscale",
              "gp.kernel.group_diff_param", "gp.kernel.embedding", "gp.Z",
              "gp.groupsZ", "gp.mu", "gp.Lu_raw", "W_raw", "V_raw")


def _tensor_maker(params, paths, device, dtype):
    """``t(path)``: a copy of ``params[path]`` on device as dtype, after
    checking that every one of ``paths`` is present."""
    missing = set(paths) - set(params)
    if missing:
        raise KeyError(f"missing leaves: {sorted(missing)}")

    def t(path, dtype=dtype):
        return torch.tensor(np.asarray(params[path]), dtype=dtype, device=device)

    return t


def _leaves(params, device, dtype):
    """Kernel and a tensor maker over the leaves of :data:`NSF_PATHS`."""
    t = _tensor_maker(params, NSF_PATHS, device, dtype)
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


def mggp_nsf_from_numpy(params, device, dtype, jitter=1e-1, var_floor=5e-2):
    """The port's :class:`MGGPNSF` over an :class:`MGGPSVGP` with an
    :class:`MGGPNSFRBF` kernel (the SQUARED convention of
    ``MGGPNSFConfig``), holding copies of ``params`` (a dict of numpy
    arrays over :data:`MGGP_PATHS`) on ``device``: float leaves as
    ``dtype``, ``gp.groupsZ`` as int64. The embedding is carried as it is:
    an MDS embedding is not unique, so rebuilding it would change it."""
    t = _tensor_maker(params, MGGP_PATHS, device, dtype)
    kernel = MGGPNSFRBF(t("gp.kernel.sigma"), t("gp.kernel.lengthscale"),
                        t("gp.kernel.group_diff_param"),
                        t("gp.kernel.embedding"),
                        input_dim=params["gp.Z"].shape[-1])
    gp = MGGPSVGP(kernel, t("gp.Z"), t("gp.groupsZ", torch.int64), t("gp.mu"),
                  t("gp.Lu_raw"), jitter=jitter, var_floor=var_floor)
    return MGGPNSF(gp, t("W_raw"), t("V_raw"))


def to_numpy(model):
    """{dotted path: numpy array} of every parameter and buffer of
    ``model`` (the MGGP SVGP's integer ``groupsZ`` is a buffer)."""
    return {path: p.detach().cpu().numpy()
            for path, p in chain(model.named_parameters(),
                                 model.named_buffers())}
