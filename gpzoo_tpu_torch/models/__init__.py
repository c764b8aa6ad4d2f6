"""Factorization heads."""

from gpzoo_tpu_torch.models.factorization import NSF

__all__ = ["NSF"]
