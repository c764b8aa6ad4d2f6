"""Covariance kernels."""

from gpzoo_tpu_torch.kernels.mggp import BatchedMGGPRBF, MGGPNSFRBF, MGGPRBF
from gpzoo_tpu_torch.kernels.rbf import NSFRBF, RBF, BatchedRBF, Matern32

__all__ = ["RBF", "NSFRBF", "BatchedRBF", "Matern32", "MGGPRBF", "MGGPNSFRBF",
           "BatchedMGGPRBF"]
