"""Carry a model between the JAX package and the port as numpy arrays:
NSF over an SVGP, a WSVGP, a LowRankWSVGP or a VNNGP, NBNSF, MGGP-NSF over
an MGGPSVGP or an MGGPWSVGP, the hybrid heads (their spatial half over
any of these), PNMF, LegacyNSF, LegacyHybridNSF and the Gaussian
likelihoods. A single-factor prior's kernel is an ``RBF``, a
``BatchedRBF`` or a ``Matern32`` (``kernel=``): the leaves do not tell
them apart.

Leaves are keyed by the JAX package's dotted paths (``train/loop.py``
``_path_str``), which are also the port's ``named_parameters`` and
``named_buffers`` names: ``prior.kernel.sigma``, ``prior.kernel.lengthscale``,
``prior.Z``, ``prior.mu``, ``prior.Lu_raw``, ``W_raw`` and ``V_raw`` for
NSF (:data:`NSF_PATHS`), ``prior.V`` and ``prior.d_raw`` in place of
``prior.Lu_raw`` for the low-rank prior, ``r_raw`` for NBNSF;
:data:`MGGP_PATHS` for MGGP-NSF; ``sf.``-prefixed GP leaves and
``sf.W_raw``, ``cf.prior.mean``, ``cf.prior.scale_raw``, ``cf.W_raw`` and
``V_raw`` for a hybrid; :data:`PNMF_PATHS` for PNMF; ``gp.``-prefixed GP
leaves for LegacyNSF, LegacyHybridNSF and the Gaussian likelihoods, with
their own fields. Static fields (jitter, var_floor, scale_pf, K) are
arguments, as the JAX models do not carry them as leaves. Flattening a
JAX model into such a dict is the caller's job; this module imports no
JAX. :func:`ngd_state_from_numpy` carries a JAX ``NGDTrainState`` (its
model, precision and Cholesky factor) into the port's.
"""

from __future__ import annotations

from itertools import chain

import numpy as np
import torch

from gpzoo_tpu_torch.gps.gaussian_prior import GaussianPrior
from gpzoo_tpu_torch.gps.mggp import MGGPSVGP, MGGPWSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP, WSVGP, LowRankWSVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP
from gpzoo_tpu_torch.kernels.mggp import MGGPNSFRBF
from gpzoo_tpu_torch.kernels.rbf import RBF, BatchedRBF, Matern32
from gpzoo_tpu_torch.models.factorization import (MGGPNSF, NBNSF, NSF, PNMF,
                                                  HybridNSF, HybridNSFExact,
                                                  LegacyHybridNSF, LegacyNSF,
                                                  PoissonFactorization)
from gpzoo_tpu_torch.models.likelihoods import ExactLikelihood, GaussianLikelihood
from gpzoo_tpu_torch.train.ngd import ngd_create

NSF_PATHS = ("prior.kernel.sigma", "prior.kernel.lengthscale", "prior.Z",
             "prior.mu", "prior.Lu_raw", "W_raw", "V_raw")
_GP_PATHS = {
    "svgp": ("kernel.sigma", "kernel.lengthscale", "Z", "mu", "Lu_raw"),
    "lowrank": ("kernel.sigma", "kernel.lengthscale", "Z", "mu", "V", "d_raw"),
    "mggp": ("kernel.sigma", "kernel.lengthscale", "kernel.group_diff_param",
             "kernel.embedding", "Z", "groupsZ", "mu", "Lu_raw"),
}
HYBRID_CF_PATHS = ("sf.W_raw", "cf.prior.mean", "cf.prior.scale_raw",
                   "cf.W_raw", "V_raw")
MGGP_PATHS = tuple("gp." + p for p in _GP_PATHS["mggp"]) + ("W_raw", "V_raw")
PNMF_PATHS = ("prior.mean", "prior.scale_raw", "W_raw", "V_raw")
LEGACY_HYBRID_PATHS = ("W_raw", "W2_raw", "mF", "scale_qF_raw", "V_raw")
_KERNELS = {"rbf": RBF, "batched": BatchedRBF, "matern32": Matern32}


def _tensor_maker(params, paths, device, dtype):
    """``t(path)``: a copy of ``params[path]`` on device as dtype, after
    checking that every one of ``paths`` is present."""
    missing = set(paths) - set(params)
    if missing:
        raise KeyError(f"missing leaves: {sorted(missing)}")

    def t(path, dtype=dtype):
        return torch.tensor(np.asarray(params[path]), dtype=dtype, device=device)

    return t


def _gp(params, prefix, kind, device, dtype, jitter, var_floor, K=None,
        kernel="rbf"):
    """The spatial prior of ``kind`` ("svgp", "wsvgp", "lowrank", "vnngp",
    "mggp" or "mggp_wsvgp") over the leaves ``prefix + path``, with a
    kernel of the class ``kernel`` names ("rbf", "batched", "matern32") if
    it is not a multi-group prior. A
    multi-group prior gets an :class:`MGGPNSFRBF` kernel (the SQUARED
    convention of the MGGP configurations) with its embedding carried as
    it is: an MDS embedding is not unique, so rebuilding it would change
    it."""
    group = kind.startswith("mggp")
    paths = _GP_PATHS["mggp" if group else "lowrank" if kind == "lowrank" else "svgp"]
    t = _tensor_maker(params, [prefix + p for p in paths], device, dtype)
    input_dim = params[prefix + "Z"].shape[-1]
    if group:
        kernel = MGGPNSFRBF(t(prefix + "kernel.sigma"), t(prefix + "kernel.lengthscale"),
                            t(prefix + "kernel.group_diff_param"),
                            t(prefix + "kernel.embedding"), input_dim=input_dim)
        args = (kernel, t(prefix + "Z"), t(prefix + "groupsZ", torch.int64),
                t(prefix + "mu"), t(prefix + "Lu_raw"))
        if kind == "mggp_wsvgp":
            return MGGPWSVGP(*args, jitter=jitter)
        return MGGPSVGP(*args, jitter=jitter, var_floor=var_floor)
    kernel = _KERNELS[kernel](t(prefix + "kernel.sigma"),
                              t(prefix + "kernel.lengthscale"), input_dim=input_dim)
    z, mu = t(prefix + "Z"), t(prefix + "mu")
    if kind == "lowrank":
        return LowRankWSVGP(kernel, z, mu, t(prefix + "V"), t(prefix + "d_raw"),
                            jitter=jitter)
    lu_raw = t(prefix + "Lu_raw")
    if kind == "wsvgp":
        return WSVGP(kernel, z, mu, lu_raw, jitter=jitter)
    if kind == "vnngp":
        return VNNGP(kernel, z, mu, lu_raw, K=K, jitter=jitter,
                     var_floor=var_floor)
    return SVGP(kernel, z, mu, lu_raw, jitter=jitter, var_floor=var_floor)


def _nsf(params, kind, device, dtype, jitter, var_floor=1e-6, K=None, kernel="rbf"):
    """NSF over the prior of ``kind``, or NBNSF when ``params`` holds r_raw."""
    gp = _gp(params, "prior.", kind, device, dtype, jitter, var_floor, K, kernel)
    t = _tensor_maker(params, ("W_raw", "V_raw"), device, dtype)
    if "r_raw" in params:
        return NBNSF(gp, t("W_raw"), t("V_raw"), t("r_raw"))
    return NSF(gp, t("W_raw"), t("V_raw"))


def nsf_from_numpy(params, device, dtype, jitter=1e-1, var_floor=1e-6, kernel="rbf"):
    """The port's :class:`NSF` over an :class:`SVGP` holding copies of
    ``params`` (a dict of numpy arrays over :data:`NSF_PATHS`) on
    ``device`` as ``dtype`` (an :class:`NBNSF` if ``params`` holds
    ``r_raw``). ``jitter`` and ``var_floor`` are the SVGP's static
    fields, which the JAX model does not carry as leaves; ``kernel`` names
    the kernel's class."""
    return _nsf(params, "svgp", device, dtype, jitter, var_floor, kernel=kernel)


def nbnsf_from_numpy(params, device, dtype, jitter=1e-1, var_floor=1e-6):
    """The port's :class:`NBNSF` over an :class:`SVGP`: the leaves of
    :data:`NSF_PATHS` and ``r_raw``."""
    _tensor_maker(params, ("r_raw",), device, dtype)
    return _nsf(params, "svgp", device, dtype, jitter, var_floor)


def wsvgp_nsf_from_numpy(params, device, dtype, jitter=1e-1, kernel="rbf"):
    """The port's :class:`NSF` (:class:`NBNSF` with ``r_raw``) over a
    :class:`WSVGP`: the leaves of :data:`NSF_PATHS`."""
    return _nsf(params, "wsvgp", device, dtype, jitter, kernel=kernel)


def lowrank_nsf_from_numpy(params, device, dtype, jitter=1e-1):
    """The port's :class:`NSF` (:class:`NBNSF` with ``r_raw``) over a
    :class:`LowRankWSVGP`: ``prior.V`` and ``prior.d_raw`` in place of
    ``prior.Lu_raw``."""
    return _nsf(params, "lowrank", device, dtype, jitter)


def vnngp_from_numpy(params, device, dtype, K, jitter=1e-1, var_floor=5e-2,
                     kernel="rbf"):
    """The port's :class:`NSF` (:class:`NBNSF` with ``r_raw``) over a
    :class:`VNNGP` holding copies of ``params`` (the leaves of
    :data:`NSF_PATHS`) on ``device`` as ``dtype``; K, ``jitter`` and
    ``var_floor`` are the VNNGP's static fields."""
    return _nsf(params, "vnngp", device, dtype, jitter, var_floor, K, kernel)


def hybrid_from_numpy(params, device, dtype, prior="svgp", exact=False,
                      jitter=1e-1, var_floor=1e-6, scale_pf=1.0, K=None):
    """The port's :class:`HybridNSF` (:class:`HybridNSFExact` with
    ``exact``) with a spatial half over the prior named by ``prior``
    ("svgp", "wsvgp", "lowrank", "mggp", "mggp_wsvgp", or "vnngp" with
    ``K``; the leaves under ``sf.prior.``) and a mean-field half over a
    :class:`GaussianPrior` of scale ``scale_pf`` (:data:`HYBRID_CF_PATHS`)."""
    gp = _gp(params, "sf.prior.", prior, device, dtype, jitter, var_floor, K)
    t = _tensor_maker(params, HYBRID_CF_PATHS, device, dtype)
    cf = PoissonFactorization(
        GaussianPrior(t("cf.prior.mean"), t("cf.prior.scale_raw"), scale_pf),
        t("cf.W_raw"))
    cls = HybridNSFExact if exact else HybridNSF
    return cls(PoissonFactorization(gp, t("sf.W_raw")), cf, t("V_raw"))


def mggp_nsf_from_numpy(params, device, dtype, jitter=1e-1, var_floor=5e-2,
                        whitened=False):
    """The port's :class:`MGGPNSF` over an :class:`MGGPSVGP` (an
    :class:`MGGPWSVGP` with ``whitened``, which has no var_floor) with an
    :class:`MGGPNSFRBF` kernel (the SQUARED convention of
    ``MGGPNSFConfig``), holding copies of ``params`` (a dict of numpy
    arrays over :data:`MGGP_PATHS`) on ``device``: float leaves as
    ``dtype``, ``gp.groupsZ`` as int64."""
    gp = _gp(params, "gp.", "mggp_wsvgp" if whitened else "mggp", device, dtype,
             jitter, var_floor)
    t = _tensor_maker(params, MGGP_PATHS, device, dtype)
    return MGGPNSF(gp, t("W_raw"), t("V_raw"))


def pnmf_from_numpy(params, device, dtype, scale_pf=1.0):
    """The port's :class:`PNMF` over a :class:`GaussianPrior` of scale
    ``scale_pf``: the leaves of :data:`PNMF_PATHS`."""
    t = _tensor_maker(params, PNMF_PATHS, device, dtype)
    return PNMF(GaussianPrior(t("prior.mean"), t("prior.scale_raw"), scale_pf),
                t("W_raw"), t("V_raw"))


def legacy_nsf_from_numpy(params, device, dtype, prior="svgp", jitter=1e-1,
                          var_floor=1e-6, K=None, kernel="rbf"):
    """The port's :class:`LegacyNSF` over the prior named by ``prior`` (as
    :func:`hybrid_from_numpy` names them, or "vnngp" with ``K``; the leaves
    under ``gp.``), ``W_raw`` and ``V_raw``."""
    gp = _gp(params, "gp.", prior, device, dtype, jitter, var_floor, K, kernel)
    t = _tensor_maker(params, ("W_raw", "V_raw"), device, dtype)
    return LegacyNSF(gp, t("W_raw"), t("V_raw"))


def legacy_hybrid_from_numpy(params, device, dtype, prior="svgp", jitter=1e-1,
                             var_floor=1e-6, K=None, kernel="rbf"):
    """The port's :class:`LegacyHybridNSF` over the prior named by ``prior``
    (the leaves under ``gp.``) and :data:`LEGACY_HYBRID_PATHS`."""
    gp = _gp(params, "gp.", prior, device, dtype, jitter, var_floor, K, kernel)
    t = _tensor_maker(params, LEGACY_HYBRID_PATHS, device, dtype)
    return LegacyHybridNSF(gp, *(t(p) for p in LEGACY_HYBRID_PATHS))


def gaussian_from_numpy(params, device, dtype, prior="svgp", exact=False,
                        jitter=1e-3, var_floor=1e-6, K=None, kernel="rbf"):
    """The port's :class:`GaussianLikelihood` (:class:`ExactLikelihood` with
    ``exact``) over the prior named by ``prior`` (the leaves under ``gp.``)
    and ``noise_raw``."""
    gp = _gp(params, "gp.", prior, device, dtype, jitter, var_floor, K, kernel)
    t = _tensor_maker(params, ("noise_raw",), device, dtype)
    return (ExactLikelihood if exact else GaussianLikelihood)(gp, t("noise_raw"))


def ngd_state_from_numpy(params, prec, prec_chol, optimizer, generator, device,
                         dtype, jitter=1e-1, var_floor=1e-6, step=0):
    """The port's ``NGDTrainState`` from a JAX one's leaves as numpy: the
    model's ``params`` (as :func:`nsf_from_numpy` takes them; NBNSF with
    ``r_raw``), ``prec`` and ``prec_chol`` (L, M, M) and the step count,
    with a fresh state of ``optimizer`` (a ``HeadAdam``) and ``generator``
    (the JAX state's optimizer state and key do not come across)."""
    state, _ = ngd_create(nsf_from_numpy(params, device, dtype, jitter, var_floor),
                          optimizer, generator)
    state.prec = torch.tensor(np.asarray(prec), dtype=dtype, device=device)
    state.prec_chol = torch.tensor(np.asarray(prec_chol), dtype=dtype, device=device)
    state.step = int(step)
    return state


def to_numpy(model):
    """{dotted path: numpy array} of every parameter and buffer of
    ``model`` (the MGGP SVGP's integer ``groupsZ`` is a buffer)."""
    return {path: p.detach().cpu().numpy()
            for path, p in chain(model.named_parameters(),
                                 model.named_buffers())}
