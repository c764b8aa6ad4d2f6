"""Factorization heads."""

from gpzoo_tpu_torch.models.factorization import MGGPNSF, NSF

__all__ = ["NSF", "MGGPNSF"]
