"""Covariance kernels."""

from gpzoo_tpu_torch.kernels.mggp import BatchedMGGPRBF, MGGPNSFRBF, MGGPRBF
from gpzoo_tpu_torch.kernels.rbf import NSFRBF, RBF

__all__ = ["RBF", "NSFRBF", "MGGPRBF", "MGGPNSFRBF", "BatchedMGGPRBF"]
