"""Variational GP priors."""

from gpzoo_tpu_torch.gps.mggp import MGGPSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP, gather_blocks

__all__ = ["SVGP", "MGGPSVGP", "VNNGP", "gather_blocks"]
