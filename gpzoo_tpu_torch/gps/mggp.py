"""Multi-group SVGPs (port of ``gpzoo_tpu/gps/mggp.py``: MGGPSVGP and
MGGPWSVGP).

The unwhitened and whitened SVGP posteriors with per-point group labels
threaded into a group-aware kernel (:mod:`gpzoo_tpu_torch.kernels.mggp`);
the inducing points carry their own fixed labels ``groupsZ``.
"""

from __future__ import annotations

import torch
from torch import nn

from gpzoo_tpu_torch.gps.svgp import WSVGP, _posterior_tail
from gpzoo_tpu_torch.ops.linalg import add_jitter


def _group_grams(gp, x, groups_x):
    """(Kxx diagonal, Kzx, Kzz + jitter·I) of a multi-group ``gp`` at the
    rows of x with labels groups_x."""
    kzz = add_jitter(gp.kernel.gram(gp.Z, gp.Z, gp.groupsZ, gp.groupsZ),
                     gp.jitter)
    return (gp.kernel.diag(x, groups_x),
            gp.kernel.gram(gp.Z, x, gp.groupsZ, groups_x), kzz)


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
        kxx, kzx, kzz = _group_grams(self, x, groups_x)
        lzz = torch.linalg.cholesky(kzz)
        w = torch.cholesky_solve(kzx, lzz).mT
        return _posterior_tail(kxx, kzz, lzz, w, self.mu, self.Lu_raw,
                               self.var_floor)


class MGGPWSVGP(WSVGP):
    """Whitened multi-group SVGP: :class:`WSVGP` whose Grams thread the
    group labels, with the fixed labels ``groupsZ`` (M,) of Z as a buffer
    (fields as :class:`MGGPSVGP`'s, without var_floor)."""

    def __init__(self, kernel, Z, groupsZ, mu, Lu_raw, jitter=1e-4):
        super().__init__(kernel, Z, mu, Lu_raw, jitter)
        self.register_buffer("groupsZ", torch.as_tensor(groupsZ, dtype=torch.int64,
                                                        device=Z.device))

    def forward(self, x, groups_x):
        """(qf, qu, None) at the rows of x with labels groups_x."""
        kxx, kzx, kzz = _group_grams(self, x, groups_x)
        lzz = torch.linalg.cholesky(kzz)
        return self._tail(kxx, torch.linalg.solve_triangular(lzz, kzx,
                                                             upper=False).mT)
