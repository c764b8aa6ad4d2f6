"""Variational GP priors and the mean-field prior of the hybrid heads."""

from gpzoo_tpu_torch.gps.gaussian_prior import GaussianPrior
from gpzoo_tpu_torch.gps.mggp import MGGPSVGP, MGGPWSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP, WSVGP, LowRankWSVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP, gather_blocks

# the reference's names
MGGP_SVGP = MGGPSVGP
MGGP_WSVGP = MGGPWSVGP

__all__ = ["SVGP", "WSVGP", "LowRankWSVGP", "MGGPSVGP", "MGGPWSVGP", "VNNGP",
           "GaussianPrior", "gather_blocks", "MGGP_SVGP", "MGGP_WSVGP"]
