"""Variational GP priors."""

from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP, gather_blocks

__all__ = ["SVGP", "VNNGP", "gather_blocks"]
