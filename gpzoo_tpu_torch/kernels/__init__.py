"""Covariance kernels."""

from gpzoo_tpu_torch.kernels.rbf import NSFRBF, RBF

__all__ = ["RBF", "NSFRBF"]
