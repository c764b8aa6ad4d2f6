"""Covariance kernels."""

from gpzoo_tpu_torch.kernels.mggp import BatchedMGGPRBF, MGGPNSFRBF, MGGPRBF
from gpzoo_tpu_torch.kernels.rbf import NSFRBF, RBF, BatchedRBF, Matern32

# the reference's names
NSF_RBF = NSFRBF
MGGP_RBF = MGGPRBF
MGGP_NSF_RBF = MGGPNSFRBF
batched_RBF = BatchedRBF
batched_Matern32 = Matern32
batched_MGGP_RBF = BatchedMGGPRBF

__all__ = ["RBF", "NSFRBF", "BatchedRBF", "Matern32", "MGGPRBF", "MGGPNSFRBF",
           "BatchedMGGPRBF", "NSF_RBF", "MGGP_RBF", "MGGP_NSF_RBF", "batched_RBF",
           "batched_Matern32", "batched_MGGP_RBF"]
