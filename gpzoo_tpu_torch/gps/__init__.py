"""Variational GP priors."""

from gpzoo_tpu_torch.gps.svgp import SVGP

__all__ = ["SVGP"]
