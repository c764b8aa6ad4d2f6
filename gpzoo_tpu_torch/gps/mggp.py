"""Multi-group SVGP (port of ``gpzoo_tpu/gps/mggp.py`` MGGPSVGP).

The unwhitened SVGP posterior with per-point group labels threaded into a
group-aware kernel (:mod:`gpzoo_tpu_torch.kernels.mggp`); the inducing
points carry their own fixed labels ``groupsZ``.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.gps.svgp import _posterior_tail
from gpzoo_tpu_torch.ops.linalg import add_jitter


class MGGPSVGP(nn.Module):
    """MGGP SVGP state:

      kernel — an MGGP kernel,
      Z (M, dim) inducing locations,
      groupsZ (M,) integer group labels of Z: a buffer, never trained,
      mu (M,) or (L, M) inducing mean,
      Lu_raw (M, M) or (L, M, M) unconstrained Cholesky of q(u),
      jitter — added to Kzz,
      var_floor — clamp of the marginal posterior variance (5e-2, the
          reference's MGGP floor, not SVGP's 1e-6).
    """

    def __init__(self, kernel, Z, groupsZ, mu, Lu_raw, jitter=1e-4,
                 var_floor=5e-2):
        super().__init__()
        self.kernel = kernel
        self.Z = nn.Parameter(Z)
        self.register_buffer("groupsZ", torch.as_tensor(groupsZ, dtype=torch.int64,
                                                        device=Z.device))
        self.mu = nn.Parameter(mu)
        self.Lu_raw = nn.Parameter(Lu_raw)
        self.jitter = jitter
        self.var_floor = var_floor

    def forward(self, x, groups_x):
        """(qf, qu, pu) at the rows of x with labels groups_x: qf the
        marginal ``Normal`` (N,) or (L, N), qu = N(mu, Lu Luᵀ),
        pu = N(0, Kzz)."""
        kxx = self.kernel.diag(x, groups_x)
        kzx = self.kernel.gram(self.Z, x, self.groupsZ, groups_x)
        kzz = add_jitter(self.kernel.gram(self.Z, self.Z, self.groupsZ,
                                          self.groupsZ), self.jitter)
        lzz = torch.linalg.cholesky(kzz)
        w = torch.cholesky_solve(kzx, lzz).mT
        return _posterior_tail(kxx, kzz, lzz, w, self.mu, self.Lu_raw,
                               self.var_floor)
