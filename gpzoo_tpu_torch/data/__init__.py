"""Held-out quality metrics."""

from gpzoo_tpu_torch.data.metrics import (held_out_deviance, poisson_deviance,
                                          posterior_deviance)

__all__ = ["poisson_deviance", "held_out_deviance", "posterior_deviance"]
